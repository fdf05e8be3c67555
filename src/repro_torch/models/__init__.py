"""The LLM behind the cache, dense family (the ported part of
``repro.models``).

    config       — ArchConfig (copied; every family's fields)
    layers       — norms, rotary, SwiGLU, initializers
    attention    — GQA attention: prefill and decode through the kernels
    transformer  — the dense decoder stack and its in-place KV cache
    model        — Model facade: init_params, init_cache, prefill, decode_step
    convert      — the reference's parameters carried across
"""

from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
