"""The benchmark's yardstick of device work: the H100's published peaks,
and the operations and bytes of a kernel call and of a model step,
computed from shapes alone.

Frozen copies, made at commit 24d51c8, of ``chip_smoke.py``'s ``bound``
(and its constants), ``scan_work`` (PERF.md §6 row 8's bytes: x and y in
x's dtype, dt fp32, B and C, A and D read once, h_final written and h0
read), the decode-attention arithmetic of ``check_decode_attention``
(row 7: the live K/V rows and q read, out written), ``expected_experts``
and ``decode_step_bound``. ``step_bound`` below extends the decode bound
to a prefill of T tokens a row by the same rules: every weight read once,
the experts that B·T tokens reach under uniform routing, the K/V or the
Mamba state written. Nothing here reads the program.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least seconds: the larger of the bytes at the HBM rate and the
    operations at ``ops_per_s``."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)


def scan_work(Bt: int, L: int, Dm: int, N: int, esz: int, with_h0: bool) -> tuple[int, int]:
    """(bytes, operations) of one mamba_scan call; 7 operations per state
    element and step."""
    n = Bt * L * Dm
    nbytes = (n * (2 * esz + 4) + 2 * Bt * L * N * 4 + Dm * (N + 1) * 4
              + Bt * Dm * N * 4 * (2 if with_h0 else 1))
    return nbytes, 7 * n * N


def decode_attention_work(B: int, Hq: int, Hkv: int, dh: int, live: int,
                          esz: int) -> tuple[int, int]:
    """(bytes, operations) of one decode_attention call over ``live``
    cached rows summed over the batch: K and V rows read, q read, out
    written, kv_len read."""
    return (esz * (2 * live * Hkv * dh + 2 * B * Hq * dh) + 4 * B, 4 * Hq * dh * live)


def expected_experts(E: int, k: int, tokens: float) -> float:
    """Distinct experts that ``tokens`` tokens reach under uniform top-k:
    an expectation from the shapes, not a count of the routing."""
    return E * (1 - (1 - k / E) ** tokens)


def step_bound(shape: dict, B: int, T: int, live: float) -> float:
    """The least seconds of one model step over B rows of T new tokens
    each (a prefill: T = prompt length; a decode step: T = 1) with
    ``live`` positions cached a row after it (the attention layers'
    K/V). ``shape`` is a reference module's ``step_shape``: the element
    counts of the dense weights (``dense``, bf16: every layer and the
    final norm), of the head (``head``, bf16: the last position of each
    row only is scored), of the experts (``experts``, bf16), of one row of
    the embedding (``d``), ``n_experts`` and ``top_k``, the per-token K/V
    elements of the attention layers (``kv_per_pos``), the Mamba state's
    fp32 elements and conv tail's elements a row (``ssm_state``,
    ``ssm_conv``), and ``attn_ops_per_pair`` (operations per query-key
    pair, summed over the attention layers). Bytes: every dense weight
    and the experts reached, read once; the batch's embedding rows; the
    K/V read (decode: the live rows) and written (the new ones); the
    Mamba state read (decode) and written. Operations: 2 per weight and
    token, the experts' for k experts a token, attention's per causal
    pair, at the bf16 tensor-core rate."""
    esz = 2
    tokens = B * T
    E, k = shape["n_experts"], shape["top_k"]
    hit = expected_experts(E, k, tokens) if E else 0.0
    exp_bytes = shape["experts"] * esz * (hit / E if E else 0.0)
    exp_ops = 2 * tokens * shape["experts"] * (k / E if E else 0.0)
    kv_read = shape["kv_per_pos"] * esz * B * (live - T) if T == 1 else 0
    kv_write = shape["kv_per_pos"] * esz * B * T
    ssm = B * (shape["ssm_state"] * 4 + shape["ssm_conv"] * esz) * (2 if T == 1 else 1)
    nbytes = ((shape["dense"] + shape["head"]) * esz + exp_bytes + kv_read + kv_write + ssm
              + tokens * shape["d"] * esz)
    pairs = B * (T * (T + 1) / 2 if T > 1 else live)
    ops = (2 * tokens * shape["dense"] + 2 * B * shape["head"] + exp_ops + shape["attn_ops_per_pair"] * pairs)
    return bound(nbytes, ops, BF16_OPS_PER_S)
