"""Helpers of the benchmark's own tests: run the harness in a subprocess
at the files' quick sizes on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "src"


def run_cell(workload: str, *extra: str, root: Path = ROOT, seconds: float = 1.0,
             seed: int = 2147483650, trace: int = 0, quick: bool = True,
             env_src: bool = True, timeout: float = 300, fault: str | None = None):
    """``portbench/run.py`` in a subprocess (with ``fault``, through
    ``faulty_run.py``): (exit code, last stdout line parsed or None,
    stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if env_src:
        env["PYTHONPATH"] = str(SRC)
    script = ["portbench/run.py"] if fault is None else \
        ["portbench/tests/faulty_run.py", "--fault", fault]
    cmd = [sys.executable, str(root / script[0]), *script[1:], "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    cmd += (["--quick"] if quick else []) + list(extra)
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr
