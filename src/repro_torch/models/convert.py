"""Carry the JAX package's parameters across to the port.

``params_from_reference`` takes the reference's parameter tree (the dict
``repro.models.Model.init_params`` returns, with every leaf turned into a
numpy array) and builds the port's parameters from it: the same values,
with the reference's group-stacked layers ("stack" → "sub<i>" → leaves of
shape (n_groups, ...)) unstacked into one dict per layer, in layer order
(group g's sub i is layer g·n_sub + i: jamba's one group of 8 sublayers
gives layers 0–7). Whisper's ``enc`` subtree comes across the same way:
``proj``, ``final_norm`` and its group-stacked encoder layers, one dict
per layer; each decoder layer's ``ln_cross`` and ``cross`` ride with its
other leaves. Every leaf is carried as it is, an MoE layer's
``router`` (d, E) fp32 and ``w_gate`` / ``w_up`` (E, d, ffe) and
``w_down`` (E, ffe, d) too: the port's grouped product takes the experts
in that order (``models/moe.py``). Tests and the
engine-parity check use it, since ``torch.Generator`` cannot reproduce
``jax.random``'s draws. It imports nothing of JAX: bfloat16 leaves arrive
as numpy arrays of the ``ml_dtypes`` bfloat16 type (2 bytes each) and are
reinterpreted bit for bit.

The tree helpers (``tree_leaves``, ``tree_map``, ``tree_unflatten``,
``tree_zip``) walk the port's parameter trees wherever they are walked:
here, in the optimizer, the train step and the checks.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (any float type, bfloat16 included) as a tensor of the
    same dtype and bits on ``device``."""
    a = np.array(a, copy=True, order="C")        # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# -- parameter trees: nested dicts and lists, tensors (or arrays) at the leaves

def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` at every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_zip(tree, *others):
    """(leaf, the node at the same place in each of ``others``), walking
    ``tree``'s structure (the others may hold dicts at its leaves)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_zip(v, *(o[k] for o in others))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_zip(v, *(o[i] for o in others))
    else:
        yield (tree, *others)


def _layers(groups: dict, n_layers: int, device) -> list[dict]:
    """A group-stacked stack ("sub<i>" -> leaves (n_groups, ...)) as one
    dict per layer, in layer order."""
    n_sub = len(groups)
    n_groups = np.asarray(groups["sub0"]["ln_mix"]).shape[0]
    if n_sub * n_groups != n_layers:
        raise ValueError(f"params_from_reference: {n_groups} groups of {n_sub} "
                         f"sublayers do not make {n_layers} layers")
    return [tree_map(lambda a, g=g: to_tensor(np.asarray(a)[g], device), groups[f"sub{i}"])
            for g in range(n_groups) for i in range(n_sub)]


def params_from_reference(np_params: dict, cfg, device) -> dict:
    """The reference's parameter tree (numpy leaves) -> the port's params
    on ``device``: embed, head, final_norm, one dict per layer, and for
    whisper ``enc`` {proj, layers, final_norm}."""
    params = {"embed": to_tensor(np_params["embed"], device),
              "head": to_tensor(np_params["head"], device),
              "final_norm": to_tensor(np_params["final_norm"], device),
              "layers": _layers(np_params["stack"], cfg.n_layers, device)}
    if "enc" in np_params:
        enc = np_params["enc"]
        params["enc"] = {"proj": to_tensor(enc["proj"], device),
                         "layers": _layers(enc["stack"], cfg.enc_layers, device),
                         "final_norm": to_tensor(enc["final_norm"], device)}
    return params
