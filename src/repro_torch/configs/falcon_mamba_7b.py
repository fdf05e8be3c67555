"""falcon-mamba-7b [ssm] — mamba1 architecture, attention-free.

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16
[arXiv:2410.05355; unverified]. d_inner = 2·d_model = 8192; runs
long_500k (state-space decode is O(1) per token in context length).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,           # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65024,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    remat="dots",
    source="arXiv:2410.05355; unverified",
)
