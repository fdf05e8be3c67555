"""model_step_mfu: the whole generation's share of the H100's published
peaks, %: for every window generation of B rows, the least time of its
prefill (B x prompt_len tokens) and of each of its decode steps
(``yardstick.step_bound``: the larger of the operations at 989 TFLOP/s
and the bytes at 3.35 TB/s), summed, over the summed ``model_generate``
span wall. The MoE bytes are an expectation from the shapes: the
experts B·T tokens reach under uniform routing."""

from portbench import yardstick


def read(run):
    P, NEW = run.mix["prompt_len"], run.mix["new_tokens"]
    gens = [sp for sp in run.spans if sp.stage == "model_generate" and sp.dur_ms]
    if not gens:
        return None
    least = 0.0
    for sp in gens:
        B = sp.attrs["batch"]
        least += yardstick.step_bound(run.shape, B, P, P)
        least += sum(yardstick.step_bound(run.shape, B, 1, P + 1 + j) for j in range(NEW - 1))
    return 100.0 * least / (sum(sp.dur_ms for sp in gens) / 1e3)
