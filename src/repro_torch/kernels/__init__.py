"""Hand-written Hopper (sm_90a) CUDA kernels for the cache data plane.

Each module holds a kernel's wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``); the CUDA sources are in
``repro_torch/csrc`` and ``_build`` compiles them with ``nvcc`` at first
use. ``ops`` is the public surface; ``ref`` holds the oracles.

    frontier_hop   — one fused HNSW beam expansion per hop
    gather_scores  — gather + dot (the beam search's entry-set scoring)
    flat_topk      — category-masked cosine top-1 over the whole table
    scatter_update — in-place row scatter (the device delta flush)
"""
