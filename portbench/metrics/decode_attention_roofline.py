"""decode_attention_roofline: the share of its roofline that the port's
decode-attention kernel reached in the traced segment, %: every launch's
bound from its shapes (``yardstick.decode_attention_work``, PERF.md §6
row 7: the live K/V rows and q read, out written, in bf16; the larger of
the bytes at 3.35 TB/s and the operations at 989 TFLOP/s), summed over
the segment's generations (per attention layer one launch a decode step,
step j over prompt_len + 1 + j positions a row), over the summed device
time of ``decode_kernel`` and its ``combine_kernel``. Nothing where the
trace holds no launch, or not one a layer and decode step."""

import re

from portbench import yardstick

KERNELS = re.compile(r"(?<!\w)decode_kernel(?!\w)")
COMBINE = re.compile(r"(?<!\w)combine_kernel(?!\w)")


def read(run):
    if run.device is None:
        return None
    cfg = run.config
    if "num_attention_heads" not in cfg:
        return None
    seconds, launches = run.device.kernel_seconds(KERNELS)
    extra, _ = run.device.kernel_seconds(COMBINE)
    L, P, NEW = cfg["num_hidden_layers"], run.mix["prompt_len"], run.mix["new_tokens"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim", cfg["hidden_size"] // H)
    if not launches or launches != L * (NEW - 1) * len(run.device_gens):
        return None
    least = 0.0
    for B in run.device_gens:
        for j in range(NEW - 1):
            nbytes, ops = yardstick.decode_attention_work(B, H, Hkv, dh, B * (P + 1 + j), 2)
            least += L * yardstick.bound(nbytes, ops, yardstick.BF16_OPS_PER_S)
    return 100.0 * least / (seconds + extra)
