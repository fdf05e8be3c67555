"""Published features of a model that ``ArchConfig`` does not carry.

``ArchConfig`` mirrors the reference's config field for field (the tests
hold the two equal), so a feature of a published model that the
reference lacks lives here, off by default, keyed by the configuration's
``name`` (a config of the port, ``configs.get_config(name)``; its
``.reduced()`` keeps the variant). Every model not in ``VARIANTS``
computes what it computed before.

* ``ssm_inner_norms``: the Mamba mixer of Jamba (HF ``JambaMambaMixer``:
  ``dt_layernorm``, ``b_layernorm``, ``c_layernorm``) puts an RMS norm
  with its own weight on Δ_in, B and C after the x-projection's split,
  before ``w_dt`` and the softplus. ``layers.init_mamba`` makes the
  weights (``dt_norm``, ``b_norm``, ``c_norm``, fp32, the port's
  ``1 + scale`` form) for such a model; ``mamba._ssm_params`` applies a
  norm wherever its weight is in the layer's parameters. The split is
  deliberate: the variant decides what a model's parameters hold, the
  parameters decide what a layer computes, so params made elsewhere (a
  reference's, a test's without the norms) run as they are.
* ``moe_renormalize``: whether the top-k routing weights are divided by
  their sum. Jamba's router (HF ``JambaSparseMoeBlock``; vLLM's Jamba
  passes ``renormalize=False``) keeps the top-k softmax probabilities as
  they are; ``moe.route`` reads it.

No positional encoding (Jamba's attention is NoPE) needs no entry:
``rope_theta=None`` skips RoPE (``attention.qkv_project``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Variant:
    ssm_inner_norms: bool = False
    moe_renormalize: bool = True


PLAIN = Variant()

# AI21-Jamba2-Mini (Jamba 1.5 / 1.6 / 1.7 Mini and Jamba2 Mini, 52B-A12B),
# huggingface.co/ai21labs/AI21-Jamba2-Mini: configs/ai21_jamba2_mini.py.
VARIANTS = {"ai21-jamba2-mini": Variant(ssm_inner_norms=True, moe_renormalize=False)}


def variant_of(cfg) -> Variant:
    """The variant of ``cfg``'s model (``PLAIN`` where the table has none);
    a ``.reduced()`` config's is its model's."""
    return VARIANTS.get(cfg.name.removesuffix("-reduced"), PLAIN)
