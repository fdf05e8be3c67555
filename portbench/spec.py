"""Where the benchmark finds what belongs to a cell: everything is looked
up by the names ``BENCHMARK.json`` gives, so a new configuration, traffic
mix or per-layer metric is a new file and a new entry, and no edit.

* ``configs/<config>.json``: the configuration, and under ``reference``
  the module of ``reference/`` that is its plain reference;
* ``traffic/<traffic>.json``: the mix's parameters;
* ``limits/<workload>.json``: the limit of each number the cell compares;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PB = Path(__file__).resolve().parent
ROOT = PB.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    path = PB / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(name: str) -> dict:
    return _json("limits", name)


def policies() -> dict:
    rows = json.loads((PB / "policies.json").read_text())["categories"]
    return {r["name"]: r for r in rows}


def reference(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def metric_reader(name: str):
    """The module ``metrics/<name>.py``, loaded by its path."""
    path = PB / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quick(cfg: dict) -> dict:
    """A configuration at its CPU rehearsal size: the file's ``quick``
    values over its own (one level into ``port``)."""
    q = cfg.get("quick", {})
    out = {**cfg, **{k: v for k, v in q.items() if k != "port"}}
    out["port"] = {**cfg["port"], **q.get("port", {})}
    return out


def quick_mix(mix: dict) -> dict:
    """A mix at its CPU rehearsal size: pools scaled by the file's
    ``quick.pool_scale``, and its other ``quick`` values."""
    q = mix.get("quick", {})
    scale = q.get("pool_scale", 1.0)
    cats = [{**c, "pool_size": max(8, int(c["pool_size"] * scale))} for c in mix["categories"]]
    return {**mix, **{k: v for k, v in q.items() if k != "pool_scale"}, "categories": cats}
