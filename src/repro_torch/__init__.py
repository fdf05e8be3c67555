"""repro_torch: the category-aware semantic cache in PyTorch, with
hand-written Hopper (sm_90a) CUDA kernels for its device data plane.

A port of ``repro`` (the JAX package, which stays the reference). It
imports ``torch`` and ``numpy`` and nothing of ``jax`` or ``repro``:

- ``repro_torch.core``    — the cache (Algorithm 1), the HNSW and flat
                            indexes with device-resident tables, and the
                            host modules they need (policy, admission,
                            storage, workload, ...).
- ``repro_torch.kernels`` — the CUDA kernels (``frontier_hop``,
                            ``gather_scores``, ``flat_topk``,
                            ``scatter_rows``), each beside its plain
                            PyTorch version, behind ``ops``.
- ``repro_torch.obs``     — deterministic spans and histograms.

Entry points run on the card: ``device=None`` resolves to ``"cuda"`` and
raises when there is none; pass ``device="cpu"`` for the CPU.
"""

__version__ = "0.1.0"
