"""decode_replay_ms: the median device time of the window's decode-graph
replays, ms: the ``decode`` device spans (``serving/engine.py:generate``,
CUDA events around each replay of a generation's decode step, placed on
the recorder's clock at the tokens' copy). Nothing where the window holds
no device span (the CPU, or a program that opens none)."""

import statistics


def read(run):
    d = [sp.dur_ms for sp in run.spans if sp.stage == "decode" and sp.dur_ms is not None
         and getattr(sp, "on", "host") == "device"]
    return statistics.median(d) if d else None
