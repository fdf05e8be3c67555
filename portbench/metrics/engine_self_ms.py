"""engine_self_ms: the engine's own time a step, ms: the median over the
window's steps of the ``engine_step`` span less its direct child spans
(``embed``, ``lookup``, ``model_generate``, ``insert``): the queue, the
batching and the response bookkeeping of ``ServingEngine.step``."""

import statistics


def read(run):
    kids = {}
    for sp in run.spans:
        if sp.parent_id >= 0 and sp.dur_ms is not None:
            kids[sp.parent_id] = kids.get(sp.parent_id, 0.0) + sp.dur_ms
    own = [sp.dur_ms - kids.get(sp.span_id, 0.0) for sp in run.spans
           if sp.stage == "engine_step" and sp.dur_ms is not None]
    return statistics.median(own) if own else None
