"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed.

32L d_model=1280 20H (kv=20 ⇒ plain MHA) d_ff=5120 vocab=51866
[arXiv:2212.04356; unverified]. 32 encoder + 32 decoder layers; the conv
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings
(B, 1500, 1280). Sinusoidal absolute positions (no RoPE).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,             # decoder layers
    enc_layers=32,
    enc_ctx=1500,
    enc_dim=1280,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    remat="dots",
    source="arXiv:2212.04356; unverified",
    notes="decode shapes exercise the decoder self-attn KV cache at the "
          "assigned lengths (mechanical; real whisper caps at 448 tokens).",
)
