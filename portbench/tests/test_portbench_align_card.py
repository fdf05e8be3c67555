"""On the card only (marker ``card``): in a traced run the program's
device spans line up with the kernels ``torch.profiler`` saw in the
traced segment, within 50 microseconds at each edge once the profiler's
own drift over the segment is taken out (``align_run.py``), and the four
span metrics are read."""

import json
import subprocess
import sys

import pytest

from pbhelp import ROOT, SRC

SPAN_METRICS = {"decode_replay_ms", "replay_gap_ms", "search_device_ms", "index_add_ms"}


@pytest.mark.card
def test_device_spans_line_up_with_the_profiled_kernels(card):
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "tests" / "align_run.py"),
                        "--workload", "falcon-mamba-7b.tail_cold", "--seed", "2147483659",
                        "--seconds", "5"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-2000:]
    row = json.loads(p.stdout.strip().splitlines()[-1])
    assert row["correct"] is True
    assert SPAN_METRICS <= set(row["metrics"])
    for stage in ("decode", "search_device"):
        edge = row["alignment"][stage]
        assert edge["spans"] > 0 and edge["widest_fit_us"] <= 50.0, (stage, edge)
