"""One run of a cell with its timed path broken underneath, for the
benchmark's own tests: the same run as ``portbench/run.py``, with one of
the port's methods replaced first.

    python3 portbench/tests/faulty_run.py --fault <name> <run.py's arguments>

Faults, each planted where the program produces what it breaks:

* ``token``: a generated token altered (every miss's middle token);
* ``stale``: the decode state returned unchanged (every token after the
  first repeats it);
* ``answer``: a cache hit's answer altered;
* ``drop``: half of each traffic step's requests never answered;
* ``insert``: the write-back stores nothing (a traffic miss's
  ``insert_batch`` returns at once; the set-up fill still goes in).
"""

import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch.core.cache import SemanticCache  # noqa: E402
from repro_torch.core.hnsw import INVALID  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def traffic(texts) -> bool:
    """Requests of the traffic (``q<row>``), not of the warm-up or fill."""
    return any(t.startswith("q") for t in texts)


def plant(fault: str) -> None:
    if fault in ("token", "stale"):
        run = ServingEngine._run

        def bad_run(self, params, tokens):
            out = run(self, params, tokens).copy()
            V = self.model.cfg.vocab_size
            if fault == "token":
                out[:, out.shape[1] // 2] = (out[:, out.shape[1] // 2] + 7) % V
            else:
                out[:, 1:] = out[:, :1]
            return out
        ServingEngine._run = bad_run
    elif fault in ("answer", "drop"):
        step = ServingEngine.step

        def bad_step(self):
            live = traffic(r.text for r in self.queue[:self.max_batch])
            out = step(self)
            if fault == "drop":
                return out[::2] if live else out
            for r in out:
                if r.cached:
                    r.text = r.text + "!"
            return out
        ServingEngine.step = bad_step
    elif fault == "insert":
        insert = SemanticCache.insert_batch

        def no_insert(self, embeddings, categories, requests, responses, metas=None):
            if traffic(requests):
                return [INVALID] * len(requests)
            return insert(self, embeddings, categories, requests, responses, metas)
        SemanticCache.insert_batch = no_insert
    else:
        raise SystemExit(f"unknown fault {fault!r}")


if __name__ == "__main__":
    k = sys.argv.index("--fault")
    plant(sys.argv[k + 1])
    sys.argv = [str(ROOT / "portbench" / "run.py")] + sys.argv[1:k] + sys.argv[k + 2:]
    runpy.run_path(sys.argv[0], run_name="__main__")
