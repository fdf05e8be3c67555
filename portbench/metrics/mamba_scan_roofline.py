"""mamba_scan_roofline: the share of its roofline that the port's
selective-scan kernel reached in the traced segment, %: every launch's
bound from its shapes (``yardstick.scan_work``, PERF.md §6 row 8: bf16
x, fp32 dt, B and C, the state written, and read by a decode step; the
larger of its bytes at 3.35 TB/s and its operations at 67 TFLOP/s),
summed over the segment's generations (per layer a prefill scan of B x
prompt_len, then a one-step scan per decode step), over the summed device
time of ``mamba_scan_kernel`` and ``mamba_step_kernel``. Nothing where
the trace holds no launch of them, or not one a layer and step."""

import re

from portbench import yardstick

KERNELS = re.compile(r"(?<!\w)mamba_(scan|step)_kernel(?!\w)")


def read(run):
    if run.device is None:
        return None
    cfg = run.config
    if "state_size" not in cfg:
        return None
    seconds, launches = run.device.kernel_seconds(KERNELS)
    L, P, NEW = cfg["num_hidden_layers"], run.mix["prompt_len"], run.mix["new_tokens"]
    Dm, N = cfg["intermediate_size"], cfg["state_size"]
    if not launches or launches != L * NEW * len(run.device_gens):
        return None
    least = 0.0
    for B in run.device_gens:
        least += L * yardstick.bound(*yardstick.scan_work(B, P, Dm, N, 2, False))
        least += L * (NEW - 1) * yardstick.bound(*yardstick.scan_work(B, 1, Dm, N, 2, True))
    return 100.0 * least / seconds
