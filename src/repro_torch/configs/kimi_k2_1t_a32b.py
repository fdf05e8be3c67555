"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table).

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8
[arXiv:2501.kimi2; unverified]. All layers MoE with expert d_ff=2048;
expert-parallel over the data axis, expert-ffn over the model axis.
grad_accum=8 keeps the routing buffers ≲1.5 GB/device at train_4k;
prefill_32k is chunked (vLLM-style) for the same reason.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,               # unused (all layers MoE); kept for reporting
    d_ff_expert=2048,
    n_experts=384,
    moe_top_k=8,
    moe_every=1,
    vocab_size=163840,
    rope_theta=50000.0,
    capacity_factor=1.25,
    remat="full",
    grad_accum=8,
    prefill_chunk=4096,
    opt_state_dtype="int8",   # 2 B/param moments: 1T params fit 512×16 GB

    source="arXiv:2501.kimi2; unverified",
)
