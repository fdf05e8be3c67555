"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
[arXiv:2408.00118; hf]. head_dim=256 (gemma2 uses wide heads: 8×256=2048).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10000.0,
    sliding_window=4096,
    local_global_alternating=True,   # even layers local(4096), odd global
    attn_softcap=50.0,
    final_softcap=30.0,
    remat="dots",
    source="arXiv:2408.00118; hf",
    notes="26 layers alternate local/global; 26%2==0 so the scan group is "
          "[local, global]×13. Embeddings gemma-scaled by sqrt(d_model).",
)
