"""insert_ms: the median of the window's ``insert`` spans, ms
(``SemanticCache.insert_batch``, the port's own span)."""

import statistics


def read(run):
    d = [sp.dur_ms for sp in run.spans if sp.stage == "insert" and sp.dur_ms is not None]
    return statistics.median(d) if d else None
