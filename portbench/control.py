"""The controls of the cells' comparisons, and the sound readings the
limits are set from, over many seeds in one process:

    python3 portbench/control.py --workload <name> --seeds 11,12,13 --seconds 10

For each seed it runs the cell as ``run.py`` does (a window of
``--seconds``) and prints one JSON line: the program's numbers as the run
compares them, and the controls' readings of the same numbers:

* ``logit_gap``: the reference put in the program's place in fp8 (e4m3,
  every product's operands rounded: ``reference.common.matmul``), the
  nearest precision below the configuration's bf16. Over the same sampled
  requests, prompts and served tokens, the gap in the fp32 reference's
  logits of the token the fp8 reference puts first at each position;
* ``hit_gap``: the cache reference in bf16 (every dot product's operands
  rounded to bf16, summed in fp32) put in the cache's place over the same
  batches of the same traffic and fill, its hits judged by the fp32
  reference as the cache's are.

Not run by the benchmark's runs. ``--quick`` runs it on the CPU at the
files' small sizes (the test of it does).
"""

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402
from portbench.reference.cache import ReferenceCache  # noqa: E402


def cache_control(ctx) -> float:
    """The bf16 cache reference's widest hit gap over the run's batches."""
    mix, tr, pols = ctx["mix"], ctx["tr"], ctx["pols"]
    judge = ReferenceCache(pols, mix["capacity"])
    ctl = ReferenceCache(pols, mix["capacity"], scores="bfloat16")
    for j, (c, e) in enumerate(zip(*ctx["fill"])):
        judge.insert(c, e, 0.0, f"fill:{j}")
        ctl.insert(c, e, 0.0, f"fill:{j}")
    worst = 0.0
    for s in ctx["steps"]:
        embs, cats = tr.embeddings[s.idx], [tr.categories[i] for i in s.idx]
        decs = ctl.decide(embs, cats, s.now)
        texts = [ctl.response[d["doc_id"]] if d["hit"] else f"ctl:{i}"
                 for i, d in zip(s.idx, decs)]
        worst = max([worst] + judge.judge_batch(embs, cats, s.now, decs, texts)["gap"])
        ctl.judge_batch(embs, cats, s.now, decs, texts)
    return worst


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the controls on the first N seeds only (default: all)")
    a = ap.parse_args(argv)
    import torch
    seeds = [int(x) for x in a.seeds.split(",")]
    n_ctl = len(seeds) if a.control_seeds is None else a.control_seeds
    for k, seed in enumerate(seeds):
        args = harness.parse(["--workload", a.workload, "--seed", str(seed), "--seconds",
                              str(a.seconds), "--trace", "0"] + (["--quick"] if a.quick else []))
        out = harness.execute(args, time.perf_counter())
        if isinstance(out, int):
            return out
        result, ctx = out
        row = {"workload": a.workload, "seed": seed,
               "program": {k: v["value"] for k, v in result["checks"].items()},
               "served_rps": result["metrics"]["served_rps"]["value"],
               "program_gaps": harness.model_gap(torch, ctx["ref"], ctx["cfg"], ctx["params"],
                                                 ctx["tr"], ctx["answers"], ctx["picked"],
                                                 ctx["mix"]["prompt_len"], ctx["device"])}
        if k < n_ctl:
            t0 = time.perf_counter()
            row["control"] = {
                "gaps": harness.model_gap(torch, ctx["ref"], ctx["cfg"], ctx["params"],
                                          ctx["tr"], ctx["answers"], ctx["picked"],
                                          ctx["mix"]["prompt_len"], ctx["device"],
                                          want_control=True),
                "hit_gap": cache_control(ctx)}
            row["control_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del ctx, out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
