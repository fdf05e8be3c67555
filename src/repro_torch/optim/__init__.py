"""Optimizer substrate: AdamW with a quantized-state option."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    apply_adamw,
    global_norm,
    init_opt_state,
)
