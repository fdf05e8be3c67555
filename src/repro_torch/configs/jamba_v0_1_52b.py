"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]. Each 8-layer block: attention at index 4, Mamba
elsewhere; MoE FFN on odd layers (16 of 32), dense d_ff=14336 on even.
Runs long_500k (sub-quadratic: 4 of 32 layers are attention; those use a
4096-token sliding window at 500 k with KV-sequence sharding).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    d_ff_expert=14336,
    n_experts=16,
    moe_top_k=2,
    moe_every=2,
    moe_offset=1,
    vocab_size=65536,
    rope_theta=10000.0,
    hybrid_period=8,
    hybrid_attn_index=4,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    capacity_factor=1.5,
    remat="dots",
    grad_accum=2,
    source="arXiv:2403.19887; hf",
)
