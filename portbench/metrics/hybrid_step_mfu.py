"""hybrid_step_mfu: ``model_step_mfu``'s reckoning with the experts
counted: for every window generation of B rows, the least time of its
prefill (B x prompt_len tokens) and of each of its decode steps, at the
H100's published peaks (``expert_yardstick.step_bound``: the larger of
the operations at 989 TFLOP/s and the bytes at 3.35 TB/s), summed, over
the summed ``model_generate`` span wall, %. The MoE bytes are those of the
experts the program counted (the span's ``experts_prefill``, and its
``experts_decode`` spread evenly over the decode steps), not the
uniform-routing expectation. Nothing where no span carries the counts
(a program that keeps none)."""

from portbench import expert_yardstick as X


def read(run):
    P, NEW = run.mix["prompt_len"], run.mix["new_tokens"]
    gens = [sp for sp in run.spans if sp.stage == "model_generate" and sp.dur_ms]
    if not gens or any("experts_prefill" not in sp.attrs for sp in gens):
        return None
    if "moe_layers" not in run.shape:
        return None
    least = 0.0
    for sp in gens:
        B = sp.attrs["batch"]
        per_step = sp.attrs["experts_decode"] / (NEW - 1)
        least += X.step_bound(run.shape, B, P, P, sp.attrs["experts_prefill"])
        least += sum(X.step_bound(run.shape, B, 1, P + 1 + j, per_step) for j in range(NEW - 1))
    return 100.0 * least / (sum(sp.dur_ms for sp in gens) / 1e3)
