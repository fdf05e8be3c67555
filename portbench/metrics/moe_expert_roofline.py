"""moe_expert_roofline: the share of their roofline that the MoE layers'
three grouped expert products (``torch._grouped_mm``: gate, up, down)
reached in the traced segment, %: each launch's bound from its shapes and
the experts it reads (``expert_yardstick.expert_products_bound``), summed
over the segment's generations (per MoE layer a prefill over B x
prompt_len tokens, then one product set per decode step over B tokens),
over the summed device time of the grouped-product kernels. The experts a
step reaches are those the program counted at that batch size in the
window (each generation's ``experts_prefill`` and ``experts_decode`` over
its MoE layers and steps, averaged over the window's generations of that
B), and the uniform expectation where the window had none of that size.
Nothing where the trace's launches are not 3 a MoE layer and step, or no
window span carries the counts."""

import re

from portbench import yardstick
from portbench import expert_yardstick as X

# ATen's CUTLASS 3 grouped GEMM (torch._grouped_mm on sm90)
KERNELS = re.compile(r"cutlass13device_kernelIN2at4cuda6detail")


def _counted(run) -> dict | None:
    """{B: (experts a MoE layer reaches in a prefill, in a decode step)},
    averaged over the window's generations of B rows."""
    NEW, n = run.mix["new_tokens"], run.shape["moe_layers"]
    sums: dict = {}
    for sp in run.spans:
        if sp.stage != "model_generate" or not sp.dur_ms:
            continue
        if "experts_prefill" not in sp.attrs:
            return None
        s = sums.setdefault(sp.attrs["batch"], [0.0, 0.0, 0])
        s[0] += sp.attrs["experts_prefill"] / n
        s[1] += sp.attrs["experts_decode"] / (n * (NEW - 1))
        s[2] += 1
    return {B: (a / c, b / c) for B, (a, b, c) in sums.items()}


def read(run):
    if run.device is None or "moe_layers" not in run.shape:
        return None
    counted = _counted(run)
    if counted is None:
        return None
    seconds, launches = run.device.kernel_seconds(KERNELS)
    P, NEW, n = run.mix["prompt_len"], run.mix["new_tokens"], run.shape["moe_layers"]
    E, k = run.shape["n_experts"], run.shape["top_k"]
    if not launches or launches != 3 * n * NEW * len(run.device_gens):
        return None
    least = 0.0
    for B in run.device_gens:
        pre, dec = counted.get(B, (yardstick.expected_experts(E, k, B * P),
                                   yardstick.expected_experts(E, k, B)))
        least += n * X.expert_products_bound(run.shape, B * P, pre)
        least += n * (NEW - 1) * X.expert_products_bound(run.shape, B, dec)
    return 100.0 * least / seconds
