"""Export surfaces for the observability pipeline.

Two text formats over the same data:

* ``prometheus_text`` — Prometheus-style exposition of the metrics
  snapshot (counters/gauges per category, ``_overall`` included) and
  the stage latency histograms (cumulative ``_bucket`` series with
  ``le`` labels, plus ``_sum``/``_count``).
* ``telemetry_report`` — human-readable per-stage p50/p95/p99 table,
  event counts and the span-accounting summary, used by
  ``launch/serve.py --telemetry`` and the bench trace dumps.

Both are deterministic: keys are sorted, floats are rounded, and no
wall-clock reads happen here.
"""

from __future__ import annotations

import math

from repro_torch.obs.trace import (TraceRecorder, coverage_fraction,
                             span_accounting)


def _prom_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _fmt_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(round(float(v), 9))


def prometheus_text(snapshot: dict | None = None,
                    rec: TraceRecorder | None = None,
                    prefix: str = "repro") -> str:
    """Render a metrics snapshot and/or trace histograms as exposition
    text.  ``snapshot`` is ``MetricsRegistry.snapshot()`` shaped (the
    ``_overall`` row becomes ``category="_overall"``)."""
    lines: list[str] = []
    if snapshot:
        fields = sorted({f for row in snapshot.values() for f in row})
        for f in fields:
            name = f"{prefix}_cache_{f}"
            kind = "gauge" if ("rate" in f or "latency" in f
                               or "seconds" in f or f == "availability"
                               ) else "counter"
            lines.append(f"# TYPE {name} {kind}")
            for cat in sorted(snapshot):
                if f not in snapshot[cat]:
                    continue
                lines.append(f'{name}{{category="{_prom_label(cat)}"}} '
                             f"{_fmt_num(snapshot[cat][f])}")
    if rec is not None:
        from repro_torch.obs.hist import bucket_upper_ms
        name = f"{prefix}_stage_latency_ms"
        lines.append(f"# TYPE {name} histogram")
        for (stage, cat, shard), h in rec.hist.items():
            base = (f'stage="{_prom_label(stage)}",'
                    f'category="{_prom_label(cat)}",shard="{shard}"')
            cum = 0
            for i in sorted(h.counts):
                cum += h.counts[i]
                le = _fmt_num(bucket_upper_ms(i))
                lines.append(f'{name}_bucket{{{base},le="{le}"}} {cum}')
            if not h.counts or bucket_upper_ms(max(h.counts)) != math.inf:
                lines.append(f'{name}_bucket{{{base},le="+Inf"}} {cum}')
            lines.append(f"{name}_sum{{{base}}} {_fmt_num(h.sum_ms)}")
            lines.append(f"{name}_count{{{base}}} {h.count}")
        name = f"{prefix}_events_total"
        lines.append(f"# TYPE {name} counter")
        for ev, n in rec.event_counts().items():
            lines.append(f'{name}{{name="{_prom_label(ev)}"}} {n}')
        lines.append(f"# TYPE {prefix}_spans_opened_total counter")
        lines.append(f"{prefix}_spans_opened_total {rec.opened}")
        lines.append(f"# TYPE {prefix}_spans_closed_total counter")
        lines.append(f"{prefix}_spans_closed_total {rec.closed}")
    return "\n".join(lines) + "\n"


def telemetry_report(rec: TraceRecorder,
                     snapshot: dict | None = None) -> str:
    """Human-readable telemetry summary for ``--telemetry``."""
    acc = span_accounting(rec)
    lines = ["telemetry report",
             f"  spans: opened={acc['opened']} closed={acc['closed']} "
             f"roots={acc['roots']} "
             f"leaf-coverage={coverage_fraction(rec):.3f}"]
    lines.append("  per-stage latency (ms):")
    lines.append(f"    {'stage':<16s} {'count':>7s} {'mean':>9s} "
                 f"{'p50':>9s} {'p95':>9s} {'p99':>9s}")
    for stage in rec.hist.stages():
        h = rec.hist.rollup(stage=stage)
        lines.append(
            f"    {stage:<16s} {h.count:>7d} {h.mean_ms:>9.3f} "
            f"{h.quantile(0.50):>9.3f} {h.quantile(0.95):>9.3f} "
            f"{h.quantile(0.99):>9.3f}")
    evc = rec.event_counts()
    if evc:
        lines.append("  events:")
        for name, n in evc.items():
            lines.append(f"    {name:<24s} {n}")
    if snapshot and "_overall" in snapshot:
        ov = snapshot["_overall"]
        lines.append(
            f"  overall: lookups={ov['lookups']} "
            f"hit_rate={ov['hit_rate']:.3f} "
            f"availability={ov.get('availability', 1.0):.3f} "
            f"degraded_s={ov.get('degraded_seconds', 0.0):.3f}")
    return "\n".join(lines)
