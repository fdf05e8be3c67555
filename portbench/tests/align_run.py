"""One traced run of a cell, then how well the program's device spans line
up with the kernels the profiler saw in the traced segment:

    python3 portbench/tests/align_run.py --workload <name> --seed <n> --seconds <s>

Prints one JSON object as the last line of standard output: the run's
per-layer metrics, and for each kind of device span (``prefill``,
``decode``, ``search_device``) in the segment how far each span's edges
lie from its kernels, in microseconds. A span's kernels are the device
events of ``portbench/trace.py``'s ``DeviceTrace`` whose middle lies
inside it; ``start_us`` is the span's start less its first kernel's start
(above 0: the span starts after that kernel), ``end_us`` its last
kernel's end less the span's end (above 0: the span ends before it). Both
lie at or below 0 where span and kernels agree: a timing event is stamped
before the stream reaches the kernel after it. Beside them, the median
span (``span_ms``) and the median time in it in which a kernel of it ran
(``busy_ms``): the rest of a span the card waited inside it.

The profiler's device times reach the host clock through one mark at the
segment's start, and can drift from it over the segment, where each
generation's spans are placed afresh at their own sync point. So a line
is fitted through the decode spans' offsets over the segment's time
(``profiler_drift``: the offset half-way between the two edges, positive
where the spans lie early), and ``widest_fit_us`` is the widest offset
once that line is taken out."""

import bisect
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

STAGES = ("prefill", "decode", "search_device")


def edges(spans, trace) -> dict:
    """Per stage, each device span of the segment with kernels in it:
    (time since the segment's start, start_us, end_us, span ms, busy ms)."""
    events = sorted(((s + d / 2, s, s + d) for _, s, d in trace.events))
    mids = [m for m, _, _ in events]
    out = {stage: [] for stage in STAGES}
    for sp in spans:
        if getattr(sp, "on", "host") != "device" or sp.stage not in out or sp.t0 < trace.t0:
            continue
        t1 = sp.t0 + sp.dur_ms / 1e3
        mine = events[bisect.bisect_left(mids, sp.t0):bisect.bisect_right(mids, t1)]
        if not mine:
            continue
        busy, at = 0.0, sp.t0
        for _, a, b in sorted(mine, key=lambda ev: ev[1]):
            a, b = max(a, at), min(b, t1)
            if b > a:
                busy += b - a
                at = b
        out[sp.stage].append((sp.t0 - trace.t0, (sp.t0 - min(a for _, a, _ in mine)) * 1e6,
                              (max(b for _, _, b in mine) - t1) * 1e6, sp.dur_ms, busy * 1e3))
    return out


def drift(decode) -> tuple[float, float]:
    """Least-squares line (µs at the segment's start, µs a second) through
    the decode spans' offsets ``(end_us - start_us) / 2`` over time."""
    if len(decode) < 2:
        return 0.0, 0.0
    xs = [t for t, *_ in decode]
    ys = [(e - s) / 2 for _, s, e, *_ in decode]
    mx, my = statistics.mean(xs), statistics.mean(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx else 0.0
    return my - b * mx, b


def alignment(spans, trace) -> dict:
    """Per device-span stage: spans matched, the widest offset (the larger
    of ``start_us`` and ``end_us`` over the spans) on the profiler's mark
    and with its drift taken out, the least, median and largest of each
    offset, and the median span and busy time; and the drift's line."""
    per = edges(spans, trace)
    a, b = drift(per["decode"])
    out = {"profiler_drift": {"at0_us": a, "slope_us_per_s": b}}
    for stage, rows in per.items():
        if not rows:
            continue
        starts = [s for _, s, *_ in rows]
        ends = [e for _, _, e, *_ in rows]
        fitted = [max(s + a + b * t, e - a - b * t) for t, s, e, *_ in rows]
        out[stage] = {
            "spans": len(rows), "widest_us": max(max(starts), max(ends)),
            "widest_fit_us": max(fitted),
            "start_us": [min(starts), statistics.median(starts), max(starts)],
            "end_us": [min(ends), statistics.median(ends), max(ends)],
            "span_ms": statistics.median(r[3] for r in rows),
            "busy_ms": statistics.median(r[4] for r in rows)}
    return out


def main(argv) -> int:
    from portbench import harness
    args = harness.parse([*argv, "--trace", "1"])
    out = harness.execute(args, T_START)
    if isinstance(out, int):
        return out
    result, ctx = out
    trace = ctx["record"].device
    row = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "alignment": alignment(ctx["spans"], trace) if trace is not None else {}}
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
