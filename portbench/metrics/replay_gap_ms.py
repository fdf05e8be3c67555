"""replay_gap_ms: the host's share of a generation, ms: the median over
the window's ``model_generate`` spans of their wall not covered by the
union of their own ``prefill`` and ``decode`` device spans (the card's
time in each graph replay): launching late between replays, the tokens'
copy in and out. Nothing where no generation of the window has device
spans (the CPU, or a program that opens none)."""

import statistics


def read(run):
    replays = {}
    for sp in run.spans:
        if (sp.stage in ("prefill", "decode") and sp.dur_ms is not None
                and getattr(sp, "on", "host") == "device"):
            replays.setdefault(sp.parent_id, []).append((sp.t0, sp.t0 + sp.dur_ms / 1e3))
    gaps = []
    for sp in run.spans:
        if sp.stage != "model_generate" or sp.dur_ms is None or sp.span_id not in replays:
            continue
        end, t1, covered = sp.t0, sp.t0 + sp.dur_ms / 1e3, 0.0
        for a, b in sorted(replays[sp.span_id]):
            a, b = max(a, end), min(b, t1)
            if b > a:
                covered += b - a
                end = b
        gaps.append(sp.dur_ms - covered * 1e3)
    return statistics.median(gaps) if gaps else None
