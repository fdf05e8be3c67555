"""index_add_ms: the median over the window's ``write`` spans
(``SemanticCache.insert_batch``'s store and index pass) of their
``index_add_ms``, ms: the index pass alone, ``HNSWIndex.add_batch``'s
host graph wiring of the step's misses, on the recorder's clock. Nothing
where no write span carries it."""

import statistics


def read(run):
    d = [sp.attrs["index_add_ms"] for sp in run.spans
         if sp.stage == "write" and "index_add_ms" in sp.attrs]
    return statistics.median(d) if d else None
