"""The readers of the device spans and of the index pass's time on
synthetic window spans (known medians and union gaps, nothing without
device spans), and a quick traced run on the CPU: ``index_add_ms`` is
read there, the three device metrics are not."""

import sys
from dataclasses import dataclass, field

import pytest

from pbhelp import ROOT, SRC, run_cell

sys.path[:0] = [str(ROOT), str(SRC)]

from portbench import spec  # noqa: E402
from portbench.harness import RunRecord  # noqa: E402
from repro_torch.obs import Span  # noqa: E402

DEVICE = ("decode_replay_ms", "replay_gap_ms", "search_device_ms")
READERS = (*DEVICE, "index_add_ms")


@dataclass
class HostOnlySpan:
    """A span of a program without device spans: no ``on`` field."""
    span_id: int
    parent_id: int
    stage: str
    category: str
    shard: int
    t0: float
    dur_ms: float | None = None
    attrs: dict = field(default_factory=dict)


def record(spans):
    return RunRecord(config={}, mix={}, shape={}, steps=[], spans=spans, lookups=0,
                     rows_gathered=0)


def window():
    """Two steps: a search, a generation with three replays (two of them
    overlapping), a write; then a search, a generation whose replays run
    past both of its ends, a write without the attribute; and a generation
    with no device span."""
    out = []

    def add(stage, parent, t0, ms, on="host", **attrs):
        out.append(Span(len(out), parent, stage, "", -1, t0, ms, attrs, on))
        return len(out) - 1

    for k, (t, add_ms) in enumerate(((10.0, 13.0), (20.0, None))):
        root = add("engine_step", -1, t, 300.0, batch=8)
        search = add("search", add("lookup", root, t, 3.0), t + 0.0005, 2.0)
        add("search_device", search, t + 0.001, (0.9, 1.1)[k], on="device", batch=8)
        gen = add("model_generate", root, t + 0.01, (100.0, 50.0)[k], batch=7)
        if k == 0:   # prefill 28 ms, then decodes covering [t+.041, t+.060]: 47 ms of 100
            add("prefill", gen, t + 0.012, 28.0, on="device", batch=7)
            add("decode", gen, t + 0.041, 10.0, on="device", batch=7, step=1)
            add("decode", gen, t + 0.050, 10.0, on="device", batch=7, step=2)
        else:        # clipped to the generation: [t+.010, t+.020] and [t+.030, t+.060]
            add("decode", gen, t + 0.009, 11.0, on="device", batch=7, step=1)
            add("decode", gen, t + 0.030, 40.0, on="device", batch=7, step=2)
        attrs = {} if add_ms is None else {"index_add_ms": add_ms}
        add("write", add("insert", root, t + 0.2, 30.0), t + 0.201, 25.0, items=7, **attrs)
    root = add("engine_step", -1, 30.0, 200.0, batch=8)
    add("model_generate", root, 30.01, 150.0, batch=8)
    add("write", add("insert", root, 30.2, 20.0), 30.201, 18.0, items=8, index_add_ms=17.0)
    return out


def test_readers_give_known_medians_and_gaps():
    run = record(window())
    got = {name: spec.metric_reader(name).read(run) for name in READERS}
    assert got["decode_replay_ms"] == pytest.approx(10.5)       # 10, 10, 11, 40
    assert got["search_device_ms"] == pytest.approx(1.0)        # 0.9, 1.1
    assert got["replay_gap_ms"] == pytest.approx((53.0 + 10.0) / 2)
    assert got["index_add_ms"] == pytest.approx(15.0)           # 13, 17


def test_readers_read_nothing_without_device_spans():
    host = [HostOnlySpan(sp.span_id, sp.parent_id, sp.stage, "", -1, sp.t0, sp.dur_ms,
                         dict(sp.attrs)) for sp in window() if sp.on == "host"]
    for name in DEVICE:
        assert spec.metric_reader(name).read(record(host)) is None
        assert spec.metric_reader(name).read(record([])) is None
    assert spec.metric_reader("index_add_ms").read(record(host)) == pytest.approx(15.0)
    for sp in host:
        sp.attrs.pop("index_add_ms", None)
    assert spec.metric_reader("index_add_ms").read(record(host)) is None


def test_quick_traced_run_reads_index_add_ms_and_no_device_span():
    rc, res, err = run_cell("falcon-mamba-7b.tail_cold", trace=1)
    assert rc == 0, err[-2000:]
    assert res["correct"] is True
    assert res["metrics"]["index_add_ms"]["value"] > 0.0
    assert not set(DEVICE) & set(res["metrics"])
