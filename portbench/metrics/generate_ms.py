"""generate_ms: the median of the window's ``model_generate`` spans, ms:
a miss batch's prefill and decode graph replays and the one copy of its
tokens to the host (``ServingEngine._generate``)."""

import statistics


def read(run):
    d = [sp.dur_ms for sp in run.spans if sp.stage == "model_generate" and sp.dur_ms is not None]
    return statistics.median(d) if d else None
