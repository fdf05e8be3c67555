"""Atomic, async checkpointing, in the reference's on-disk format.

The counterpart of ``repro.checkpoint.checkpoint``. Layout (one directory
per step), the reference's:

    ckpt_dir/step_000000123/
        manifest.json      — leaf paths, dtypes and shapes, extras
        arrays.npz         — flat {leaf_path: ndarray}; fp32/bf16/int8 kept
    ckpt_dir/step_000000123.tmp  → atomically renamed when complete

bf16 leaves round-trip as a uint16 view (npz has no bf16), so a
checkpoint written by either package restores in the other with the same
bits. Leaves may be tensors (any device) or numpy arrays; a list in the
tree (the port's one dict per layer) is stored under its indices
("layers/0/mix/wq") and comes back as a list: a dict whose keys are
exactly "0" … "n-1" is read as one.

``restore_checkpoint`` places every leaf on the given device. With
``plan=`` (a spec tree like the checkpoint's tree: the training plan for
"params", ``opt_plan``'s for "opt") and ``dist=`` it restores onto the
current mesh, each rank taking its blocks (``launch.sharding.shard_tree``):
the counterpart of the reference's ``shardings=`` elastic re-placement.
Every rank reads the whole file and keeps its blocks. A mesh run saves
the gathered full leaves (``launch.sharding.gather_tree``, rank 0
writes), so the format is the one-process one: a checkpoint written by
one process restores onto a mesh, and one written on a mesh into one
process, bit for bit.

``AsyncCheckpointer.save`` copies every tensor to host memory before it
returns, and a writer thread persists the copy. The optimizer updates
the parameters in place at the next step (JAX arrays are immutable; torch
tensors are not), so a file written from the live tensors could hold
parts of two steps.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.hnsw import resolve_device


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _lists(node):
    """Dicts keyed exactly "0" … "n-1" as lists, all the way down."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(map(str, range(len(node)))):
        return [node[str(i)] for i in range(len(node))]
    return node


def _unflatten(flat: dict):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return _lists(tree)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its dtype name (bf16 as a uint16 view)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(x, copy=True)
        if arr.dtype.name == "bfloat16":       # the reference's ml_dtypes bf16
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(arr)              # npz hands out a fresh array
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _write(ckpt_dir: str, step: int, arrays: dict, dtypes: dict,
           extras: dict | None, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extras": extras or {},
                "leaves": {path: {"dtype": dtypes[path], "shape": list(arr.shape)}
                           for path, arr in arrays.items()}}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(final):         # same-step overwrite (emergency save)
        shutil.rmtree(final)
    os.replace(tmp, final)           # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _snapshot(tree) -> tuple[dict, dict]:
    """Every leaf copied to host numpy now: (arrays, dtype names)."""
    arrays, dtypes = {}, {}
    for path, leaf in _flatten(tree).items():
        arrays[path], dtypes[path] = _to_numpy(leaf)
    return arrays, dtypes


def save_checkpoint(ckpt_dir: str, step: int, tree: dict,
                    extras: dict | None = None, keep: int = 3) -> str:
    """Atomic checkpoint write. ``extras`` = JSON-serializable state
    (data-pipeline cursor, RNG, config fingerprint)."""
    return _write(ckpt_dir, step, *_snapshot(tree), extras, keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if re.fullmatch(r"step_\d+", d))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if re.fullmatch(r"step_\d+", d)]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None, device=None, *,
                       plan: dict | None = None, dist=None) -> tuple[dict, dict, int]:
    """Returns (tree, extras, step), every leaf a tensor on ``device``
    (None: the card): the whole leaf, or under ``plan`` and a mesh
    ``dist`` this rank's block of it."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        flat = {leaf: _to_tensor(npz[leaf], meta["dtype"], "cpu" if plan else device)
                for leaf, meta in manifest["leaves"].items()}
    tree = _unflatten(flat)
    if plan is not None:
        from repro_torch.launch.sharding import shard_tree
        from repro_torch.models.convert import tree_map
        if dist is not None and dist.mesh is not None:
            tree = shard_tree(tree, plan, dist)
        tree = tree_map(lambda t: t.to(device), tree)
    return tree, manifest["extras"], step


class AsyncCheckpointer:
    """Writer-thread checkpointing: ``save`` snapshots every leaf to host
    memory before it returns (training goes on to overwrite the tensors in
    place) and persists the snapshot in the background."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree: dict, extras: dict | None = None) -> None:
        self.wait()
        arrays, dtypes = _snapshot(tree)

        def run():
            try:
                _write(self.ckpt_dir, step, arrays, dtypes, extras, self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
