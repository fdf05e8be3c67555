"""The LLM behind the cache, dense, moe, ssm and hybrid families (the
ported part of ``repro.models``).

    config       — ArchConfig (copied; every family's fields)
    layers       — norms, rotary, SwiGLU, initializers (attention, Mamba, MoE)
    attention    — GQA attention: prefill and decode through the kernels
    moe          — mixture-of-experts FFN (stable sort by expert, grouped
                   products, weighted combine)
    mamba        — the Mamba1 block through the selective-scan kernel
    transformer  — the decoder stack (attention or Mamba, then a dense, MoE
                   or no FFN) and its in-place K/V and Mamba-state cache
    model        — Model facade: init_params, init_cache, prefill, decode_step
    convert      — the reference's parameters carried across; the
                   parameter-tree helpers (tree_leaves, tree_map, ...)
"""

from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
