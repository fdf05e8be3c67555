"""Assigned architecture configs (+ shapes).

``get_config(arch_id)`` returns the exact assigned ``ArchConfig``;
``SHAPES`` maps shape ids to (seq_len, global_batch, step kind);
``runnable_cells()`` enumerates the dry-run matrix with documented skips
(DESIGN.md §5).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "gemma2_2b",
    "deepseek_67b",
    "llama3_2_3b",
    "granite_8b",
    "whisper_large_v3",
    "kimi_k2_1t_a32b",
    "granite_moe_3b_a800m",
    "jamba_v0_1_52b",
    "llava_next_mistral_7b",
    "falcon_mamba_7b",
]

# Canonical hyphenated ids from the assignment → module names.
ALIASES = {
    "gemma2-2b": "gemma2_2b",
    "deepseek-67b": "deepseek_67b",
    "llama3.2-3b": "llama3_2_3b",
    "granite-8b": "granite_8b",
    "whisper-large-v3": "whisper_large_v3",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention (DESIGN.md §5): run only for the
# SSM/hybrid archs; everything else is recorded as an explicit skip.
LONG_CONTEXT_ARCHS = {"jamba_v0_1_52b", "falcon_mamba_7b"}


def get_config(arch_id: str) -> ArchConfig:
    mod_name = ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def runnable_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            cells.append((arch, shape))
        if arch in LONG_CONTEXT_ARCHS:
            cells.append((arch, "long_500k"))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    return [(arch, "long_500k", "quadratic-attention")
            for arch in ARCH_IDS if arch not in LONG_CONTEXT_ARCHS]
