"""One run of a cell with one of the port's published-model features
switched back to the behaviour the port had without it, for the
benchmark's own tests (at the quick size) and for a check at size on the
card: the same run as ``portbench/run.py``, with the program changed
first.

    python3 portbench/tests/variant_faulty_run.py --fault <name> <run.py's arguments>

Faults (``ai21-jamba2-mini``'s features, ``src/repro_torch/models/variants.py``):

* ``rope``: RoPE put back on the attention layers (``rope_theta`` 10,000
  where the configuration gives none);
* ``renorm``: the top-k routing weights renormalised;
* ``norms``: the Mamba mixer's Δ / B / C norms dropped (the program is
  handed the weights without them; the reference keeps its own).
"""

import dataclasses
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch.models import variants  # noqa: E402
from repro_torch.models.mamba import INNER_NORMS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def plant(fault: str) -> None:
    if fault == "rope":
        post_init = Model.__post_init__

        def roped(self):
            if self.cfg.rope_theta is None:
                self.cfg = dataclasses.replace(self.cfg, rope_theta=10000.0)
            post_init(self)
        Model.__post_init__ = roped
    elif fault == "renorm":
        variants.VARIANTS = {name: dataclasses.replace(v, moe_renormalize=True)
                             for name, v in variants.VARIANTS.items()}
    elif fault == "norms":
        init = ServingEngine.__init__

        def without_norms(self, model, params, *a, **kw):
            layers = [{**sp, "mix": {k: v for k, v in sp["mix"].items()
                                     if k not in INNER_NORMS}} for sp in params["layers"]]
            init(self, model, {**params, "layers": layers}, *a, **kw)
        ServingEngine.__init__ = without_norms
    else:
        raise SystemExit(f"unknown fault {fault!r}")


if __name__ == "__main__":
    k = sys.argv.index("--fault")
    plant(sys.argv[k + 1])
    sys.argv = [str(ROOT / "portbench" / "run.py")] + sys.argv[1:k] + sys.argv[k + 2:]
    runpy.run_path(sys.argv[0], run_name="__main__")
