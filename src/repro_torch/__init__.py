"""repro_torch: the category-aware semantic cache and the LLM behind it in
PyTorch, with hand-written Hopper (sm_90a) CUDA kernels for the cache's
device data plane, the model's attention and its selective scan.

A port of ``repro`` (the JAX package, which stays the reference). It
imports ``torch`` and ``numpy`` and nothing of ``jax`` or ``repro``:

- ``repro_torch.core``    — the cache (Algorithm 1), the HNSW and flat
                            indexes with device-resident tables, and the
                            host modules they need (policy, admission,
                            storage, workload, ...).
- ``repro_torch.kernels`` — the CUDA kernels (``frontier_hop``,
                            ``gather_scores``, ``gather_scores_masked``,
                            ``flat_topk``, ``scatter_rows``,
                            ``flash_attention``, ``decode_attention``,
                            ``mamba_scan``), each beside its plain
                            PyTorch version, behind ``ops``.
- ``repro_torch.models``  — the dense decoder (llama3.2-3b and kin) and
                            the ssm one (falcon-mamba-7b): prefill and
                            decode through the kernels, an in-place
                            cache; ``configs`` holds the ten
                            architectures.
- ``repro_torch.serving`` — the engine: cache in front of the model;
                            ``launch.serve`` is its driver and CLI.
- ``repro_torch.obs``     — deterministic spans, histograms and exports.

Entry points run on the card: ``device=None`` resolves to ``"cuda"`` and
raises when there is none; pass ``device="cpu"`` for the CPU.
"""

__version__ = "0.1.0"
