"""The harness end to end at the quick sizes on the CPU: every cell's
result line, the traced per-layer metrics, and the runs that must print
no result."""

import json
import shutil

import pytest

from pbhelp import ROOT, run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("workload", CELLS)
def test_quick_run_prints_result(workload):
    rc, res, err = run_cell(workload)
    assert rc == 0, err[-2000:]
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"served_rps", "latency_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    for name, c in res["checks"].items():
        assert f"check {name}: " in err


def test_quick_traced_run_reads_span_metrics():
    rc, res, err = run_cell(CELLS[0], trace=1)
    assert rc == 0, err[-2000:]
    assert res["correct"] is True
    # the device metrics need the card's trace; the span and counter ones do not
    assert {"engine_self_ms", "lookup_ms", "insert_ms", "rows_per_lookup",
            "generate_ms", "model_step_mfu"} <= set(res["metrics"])
    assert not {"device_idle_share", "mamba_scan_roofline"} & set(res["metrics"])
    assert "served_rps" not in res["metrics"]


def test_quick_traced_warm_run_reads_index_recall():
    """A warm cache has hits to find: the recall is read, as a share."""
    rc, res, err = run_cell("falcon-mamba-7b.head_warm", trace=1, seconds=2.0)
    assert rc == 0, err[-2000:]
    assert res["correct"] is True
    assert 0.0 < res["metrics"]["index_recall"]["value"] <= 100.0


def test_no_card_no_result():
    rc, res, err = run_cell(CELLS[0], quick=False)
    assert rc != 0 and res is None
    assert "CUDA device" in err


def test_bare_checkout_fails(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ runs nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, res, _ = run_cell(CELLS[0], root=tmp_path, env_src=False)
    assert rc != 0 and res is None
