"""The LLM behind the cache, dense and ssm families (the ported part of
``repro.models``).

    config       — ArchConfig (copied; every family's fields)
    layers       — norms, rotary, SwiGLU, initializers (attention, Mamba)
    attention    — GQA attention: prefill and decode through the kernels
    mamba        — the Mamba1 block through the selective-scan kernel
    transformer  — the decoder stack (attention + SwiGLU, or Mamba) and its
                   in-place K/V and Mamba-state cache
    model        — Model facade: init_params, init_cache, prefill, decode_step
    convert      — the reference's parameters carried across
"""

from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
