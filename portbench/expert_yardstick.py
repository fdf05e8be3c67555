"""The yardstick of a model step whose MoE bytes are counted, not
expected: ``yardstick.step_bound``'s arithmetic with the experts the
program reports it reached (``EngineStats.experts_prefill`` /
``experts_decode``, the ``model_generate`` span's attributes) in place of
the uniform-routing expectation, and the bound of the three grouped
expert products of one MoE layer and step. Computed from shapes and
counts alone; nothing here reads the program.

``step_work(shape, B, T, live)`` with ``reached`` None gives the operands
of ``yardstick.step_bound`` exactly (held by a test), so the two
yardsticks differ only in the experts' bytes.
"""

from __future__ import annotations

from portbench import yardstick as Y

ESZ = 2                        # bf16 weights and activations


def step_work(shape: dict, B: int, T: int, live: float,
              reached: float | None = None) -> tuple[float, float]:
    """(bytes, operations) of one model step over B rows of T new tokens
    each with ``live`` positions cached a row after it, as
    ``yardstick.step_bound`` counts them. ``reached``: the experts the
    step's MoE layers reached, summed over the layers (each layer's
    distinct experts); None takes the uniform-routing expectation."""
    tokens = B * T
    E, k = shape["n_experts"], shape["top_k"]
    if not E:
        exp_bytes = 0.0
    elif reached is None:
        exp_bytes = shape["experts"] * ESZ * (Y.expected_experts(E, k, tokens) / E)
    else:
        exp_bytes = shape["expert"] * ESZ * reached
    exp_ops = 2 * tokens * shape["experts"] * (k / E if E else 0.0)
    kv_read = shape["kv_per_pos"] * ESZ * B * (live - T) if T == 1 else 0
    kv_write = shape["kv_per_pos"] * ESZ * B * T
    ssm = B * (shape["ssm_state"] * 4 + shape["ssm_conv"] * ESZ) * (2 if T == 1 else 1)
    nbytes = ((shape["dense"] + shape["head"]) * ESZ + exp_bytes + kv_read + kv_write + ssm
              + tokens * shape["d"] * ESZ)
    pairs = B * (T * (T + 1) / 2 if T > 1 else live)
    ops = (2 * tokens * shape["dense"] + 2 * B * shape["head"] + exp_ops
           + shape["attn_ops_per_pair"] * pairs)
    return nbytes, ops


def step_bound(shape: dict, B: int, T: int, live: float, reached: float | None = None) -> float:
    """The least seconds of ``step_work``'s step at the H100's bf16 peak
    and HBM rate."""
    return Y.bound(*step_work(shape, B, T, live, reached), Y.BF16_OPS_PER_S)


def expert_products_bound(shape: dict, tokens: int, reached: float) -> float:
    """The least seconds of one MoE layer's three grouped expert products
    (gate, up: rows (tokens·k, d) times each reached expert's (d, ffe);
    down: (tokens·k, ffe) times its (ffe, d)) over ``tokens`` tokens that
    reach ``reached`` distinct experts: each product's input rows and the
    reached experts' weights read once, its output written once, bf16; the
    larger of the bytes at 3.35 TB/s and the operations at 989 TFLOP/s,
    summed over the three launches."""
    rows = tokens * shape["top_k"]
    w = shape["expert"] // 3                     # one expert's d·ffe of one product
    ffe = w // shape["d"]
    total = 0.0
    for k_in, k_out in ((shape["d"], ffe), (shape["d"], ffe), (ffe, shape["d"])):
        nbytes = ESZ * (rows * k_in + reached * w + rows * k_out)
        total += Y.bound(nbytes, 2 * rows * w, Y.BF16_OPS_PER_S)
    return total
