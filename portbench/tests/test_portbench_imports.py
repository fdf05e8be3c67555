"""What the benchmark runs loads neither JAX nor the JAX package
(top-level module names compared whole: ``repro_torch`` is not
``repro``), and its references load nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from pbhelp import ROOT, SRC

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PB = ROOT / "portbench"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax_and_references_no_port():
    for path in PB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not imported_tops(path) & FORBIDDEN, path
    for path in (PB / "reference").glob("*.py"):
        assert "repro_torch" not in imported_tops(path), path


def test_a_run_loads_no_jax():
    """A whole quick run in one process, then its modules: no forbidden
    top-level name, and repro_torch is there (it is the system run)."""
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
        "from portbench import harness\n"
        "args = harness.parse(['--workload', 'granite-moe-3b-a800m.tail_cold', '--seed', '9',"
        " '--seconds', '1', '--quick'])\n"
        "res, _ = harness.execute(args, time.perf_counter())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN and "repro_torch" in tops


def test_references_load_no_port():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
            "import portbench.reference.cache, portbench.reference.mamba1, "
            "portbench.reference.granite_moe, portbench.yardstick, portbench.traffic_gen\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "repro_torch" not in p.stdout and "'jax'" not in p.stdout
