"""A new configuration, traffic mix and per-layer metric are new files
and new entries, and no edit: in a temporary copy of the benchmark, a
throwaway one of each is picked up by its name."""

import json
import shutil

from pbhelp import ROOT, run_cell


def test_new_config_mix_and_metric_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "falcon-mamba-7b.json").read_text())
    cfg["port"]["name"] = "tiny-mamba"
    (pb / "configs" / "tiny-mamba.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "tail_cold.json").read_text())
    mix["categories"] = mix["categories"][:2]
    (pb / "traffic" / "two_tails.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny-mamba.two_tails.json").write_text(
        (pb / "limits" / "falcon-mamba-7b.tail_cold.json").read_text())
    (pb / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return float(len(run.steps))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "tiny-mamba",
                             "file": "portbench/configs/tiny-mamba.json"})
    bench["workloads"].append({"name": "tiny-mamba.two_tails", "config": "tiny-mamba",
                               "traffic": "two_tails", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "engine (serving/engine.py)",
                               "moves": "served_rps", "workloads": ["tiny-mamba.two_tails"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cell("tiny-mamba.two_tails", root=tmp_path, trace=1)
    assert rc == 0, err[-2000:]
    assert res["correct"] is True and res["metrics"]["steps_seen"]["value"] > 0
    assert "conversational_chat" in err and "legal_queries" not in err.split("hit rate")[1]
