"""lookup_ms: the median of the window's ``lookup`` spans, ms
(``SemanticCache.lookup_batch``, the port's own span)."""

import statistics


def read(run):
    d = [sp.dur_ms for sp in run.spans if sp.stage == "lookup" and sp.dur_ms is not None]
    return statistics.median(d) if d else None
