"""Hand-written Hopper (sm_90a) CUDA kernels: the cache data plane, the
model's attention and its Mamba layers' selective scan.

Each module holds a kernel's wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``); the CUDA sources are in
``repro_torch/csrc`` and ``_build`` compiles them with ``nvcc`` at first
use. ``ops`` is the public surface; ``ref`` holds the oracles.

    frontier_hop     — one fused HNSW beam expansion per hop
    gather_scores    — gather + dot (the beam search's entry-set scoring),
                       and its category-masked variant
    flat_topk        — category-masked cosine top-1 over the whole table
    scatter_update   — in-place row scatter (the device delta flush)
    flash_attention  — tiled GQA prefill attention (causal/window/softcap):
                       wgmma on the tensor cores for bf16, fp32 FMA for fp32
    decode_attention — one-token GQA decode against a ragged KV cache,
                       optionally windowed, rows split across blocks
    mamba_scan       — the Mamba1 selective scan, state carried over L
"""
