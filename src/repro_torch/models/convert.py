"""Carry the JAX package's parameters across to the port.

``params_from_reference`` takes the reference's parameter tree (the dict
``repro.models.Model.init_params`` returns, with every leaf turned into a
numpy array) and builds the port's parameters from it: the same values,
with the reference's group-stacked layers ("stack" → "sub<i>" → leaves of
shape (n_groups, ...)) unstacked into one dict per layer. Tests and the
engine-parity check use it, since ``torch.Generator`` cannot reproduce
``jax.random``'s draws. It imports nothing of JAX: bfloat16 leaves arrive
as numpy arrays of the ``ml_dtypes`` bfloat16 type (2 bytes each) and are
reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tf


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (any float type, bfloat16 included) as a tensor of the
    same dtype and bits on ``device``."""
    a = np.array(a, copy=True, order="C")        # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, fn):
    return {k: _tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def params_from_reference(np_params: dict, cfg, device) -> dict:
    """The reference's parameter tree (numpy leaves) -> the port's params
    on ``device``: embed, head, final_norm, and one dict per layer."""
    tf.check_ported(cfg)
    groups = np_params["stack"]
    n_sub = len(groups)
    n_groups = np.asarray(groups["sub0"]["ln_mix"]).shape[0]
    if n_sub * n_groups != cfg.n_layers:
        raise ValueError(f"params_from_reference: {n_groups} groups of {n_sub} "
                         f"sublayers do not make {cfg.n_layers} layers")
    layers = [_tree(groups[f"sub{i}"], lambda a, g=g: to_tensor(np.asarray(a)[g], device))
              for g in range(n_groups) for i in range(n_sub)]
    return {"embed": to_tensor(np_params["embed"], device),
            "head": to_tensor(np_params["head"], device),
            "final_norm": to_tensor(np_params["final_norm"], device),
            "layers": layers}
