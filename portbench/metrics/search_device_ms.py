"""search_device_ms: the median device time of the window's index
searches, ms: the ``search_device`` device spans (``core/cache.py``'s
lookup, CUDA events around the delta flush and the search's graph
replay, ending before the result's host copy). Nothing where the window
holds no device span (the CPU, or a program that opens none)."""

import statistics


def read(run):
    d = [sp.dur_ms for sp in run.spans if sp.stage == "search_device" and sp.dur_ms is not None
         and getattr(sp, "on", "host") == "device"]
    return statistics.median(d) if d else None
