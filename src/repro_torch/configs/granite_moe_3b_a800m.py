"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]. Experts are zero-padded to
a multiple of the data-axis size for EP (40 → 48 on a 16-wide axis).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    d_ff_expert=512,
    n_experts=40,
    moe_top_k=8,
    moe_every=1,
    vocab_size=49155,
    rope_theta=10000.0,
    capacity_factor=1.5,
    remat="dots",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
