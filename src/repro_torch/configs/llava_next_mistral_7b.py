"""llava-next-mistral-7b [vlm] — anyres tiling, mistral-7b backbone.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. The vision frontend is
a STUB: ``input_specs()`` provides precomputed anyres patch embeddings
(B, 2880, d_model) = 5 tiles × 576 patches, prepended to the text tokens.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    n_patches=2880,
    remat="dots",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
