"""On the card only (marker ``card``; the ``card`` fixture skips without
one): a cell at its size comes out correct, and its controls read beyond
its limits."""

import json
import subprocess
import sys

import pytest

from pbhelp import ROOT, SRC, run_cell


@pytest.mark.card
def test_cell_at_size_is_correct(card):
    rc, res, err = run_cell("falcon-mamba-7b.tail_cold", quick=False, seconds=5.0, timeout=1200)
    assert rc == 0, err[-2000:]
    assert res["correct"] is True and res["device"]["kind"] == card


@pytest.mark.card
def test_controls_exceed_the_limits_at_size(card):
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "control.py"), "--workload",
                        "falcon-mamba-7b.tail_cold", "--seeds", "2147483653", "--seconds", "5"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-2000:]
    row = json.loads(p.stdout.strip().splitlines()[-1])
    limits = json.loads((ROOT / "portbench" / "limits" /
                         "falcon-mamba-7b.tail_cold.json").read_text())
    assert row["control"]["gaps"]["max"] > limits["logit_gap"]
    assert row["control"]["hit_gap"] > limits["hit_gap"]
