"""ai21-jamba2-mini [hybrid] — AI21-Jamba2-Mini (Jamba 1.5/1.6/1.7 Mini
and Jamba2 Mini, 52B-A12B), huggingface.co/ai21labs/AI21-Jamba2-Mini.

jamba-v0.1-52b's shapes one for one (32L d_model=4096 32H GQA kv=8 of 128,
d_ff=14336, 16 experts of 14336 top-2 on odd layers, attention at index 4
of every 8 layers, Mamba-1 d_inner 8192 state 16 conv 4 Δ rank 256, vocab
65536, rms_norm_eps 1e-6), with the three features of the published layer
equations that the reference's jamba lacks: no positional encoding
(``rope_theta=None``), and by its name the variant of
``models/variants.py``: RMS norms on the Mamba mixer's Δ_in, B and C, and
top-2 routing weights not renormalised. Not in ``ARCH_IDS``: the reference
package has no such config. The benchmark's cell runs it cut to 16 layers
(``portbench/configs/ai21-jamba2-mini.json``).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="ai21-jamba2-mini",
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
    rope_theta=None,
    hybrid_period=8,
    hybrid_attn_index=4,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    norm_eps=1e-6,
    source="huggingface.co/ai21labs/AI21-Jamba2-Mini; arXiv:2403.19887",
)
