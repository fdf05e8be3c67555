"""The ai21-jamba2-mini cell: a quick run on the CPU is correct and reads
``hybrid_step_mfu``; each of the model's three features switched back
underneath the run (``variant_faulty_run.py``) turns ``correct`` false;
the counted-experts yardstick is ``yardstick.step_bound`` where it is
given the expectation; the two new readers read known numbers off
synthetic spans and nothing off a program that keeps no counts; and, on
the card only, a traced run at size reports both."""

import json
import os
import subprocess
import sys
from dataclasses import dataclass, field

import pytest

from pbhelp import ROOT, SRC, run_cell

sys.path[:0] = [str(ROOT), str(SRC)]

from portbench import expert_yardstick as X  # noqa: E402
from portbench import spec, yardstick  # noqa: E402
from portbench.harness import RunRecord  # noqa: E402
from portbench.trace import DeviceTrace  # noqa: E402

CELL = "ai21-jamba2-mini.tail_cold"
CFG = spec.config("ai21-jamba2-mini")
SHAPE = spec.reference(CFG).step_shape(CFG)
MIX = spec.traffic("tail_cold")
GROUPED = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6"
           "kernel13GemmUniversal")


def faulty(fault: str, seconds: float = 2.0):
    """``variant_faulty_run.py`` at the quick size: (exit code, result)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    # torch's default pool in each of a parallel test run's workers
    # oversubscribes the cores: one thread keeps the run well inside its limit
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "tests" / "variant_faulty_run.py"),
                        "--fault", fault, "--workload", CELL, "--seed", "2147483650",
                        "--seconds", str(seconds), "--trace", "0", "--quick"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


def test_quick_traced_run_is_correct_and_reads_the_step_mfu():
    rc, res, err = run_cell(CELL, trace=1, seconds=2.0)
    assert rc == 0, err[-2000:]
    assert res["correct"] is True
    assert res["metrics"]["hybrid_step_mfu"]["value"] > 0.0
    assert "moe_expert_roofline" not in res["metrics"]        # needs the card's trace


@pytest.mark.parametrize("fault", ["rope", "renorm", "norms"])
def test_a_feature_switched_back_turns_correct_false(fault):
    rc, res, err = faulty(fault)
    assert rc == 0, err[-2000:]
    assert res["correct"] is False
    check = res["checks"]["logit_gap_mean"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("cfg_name", ["falcon-mamba-7b", "granite-moe-3b-a800m",
                                      "ai21-jamba2-mini"])
@pytest.mark.parametrize("B,T,live", [(8, 64, 64), (8, 1, 72), (3, 1, 79), (1, 64, 64)])
def test_counted_yardstick_is_the_expected_one_given_the_expectation(cfg_name, B, T, live):
    cfg = spec.config(cfg_name)
    shape = spec.reference(cfg).step_shape(cfg)
    assert X.step_bound(shape, B, T, live) == yardstick.step_bound(shape, B, T, live)
    if cfg_name == "ai21-jamba2-mini":
        E, k, n = shape["n_experts"], shape["top_k"], shape["moe_layers"]
        expected = n * yardstick.expected_experts(E, k, B * T)
        assert X.step_bound(shape, B, T, live, expected) == \
            pytest.approx(yardstick.step_bound(shape, B, T, live), rel=1e-12)


def test_expert_products_bound_by_bytes_at_decode():
    """A decode step at B 8 reaching 10.5 experts: three launches bound by
    the experts' weight bytes, 10.5 · 3 · d · ffe · 2 B at 3.35 TB/s."""
    t = X.expert_products_bound(SHAPE, 8, 10.5)
    weights = 10.5 * SHAPE["expert"] * 2 / yardstick.HBM_BYTES_PER_S
    assert weights < t < 1.001 * weights


@dataclass
class Sp:
    stage: str
    dur_ms: float
    attrs: dict = field(default_factory=dict)
    t0: float = 0.0


def record(spans, device=None, gens=()):
    return RunRecord(config=CFG, mix=MIX, shape=SHAPE, steps=[], spans=spans, lookups=0,
                     rows_gathered=0, device=device, device_gens=list(gens))


def generations(counts=True):
    """Two window generations at B 8 and one at B 7; each MoE layer
    reaches all 16 experts in the prefill and 10 in a decode step."""
    n, NEW = SHAPE["moe_layers"], MIX["new_tokens"]
    out = []
    for B, ms in ((8, 400.0), (8, 420.0), (7, 380.0)):
        attrs = {"batch": B}
        if counts:
            attrs.update(experts_prefill=16 * n, experts_decode=10 * n * (NEW - 1))
        out.append(Sp("model_generate", ms, attrs))
    return out


def test_hybrid_step_mfu_reads_the_counted_bound():
    P, NEW = MIX["prompt_len"], MIX["new_tokens"]
    n = SHAPE["moe_layers"]
    want = 0.0
    for B in (8, 8, 7):
        want += X.step_bound(SHAPE, B, P, P, 16 * n)
        want += sum(X.step_bound(SHAPE, B, 1, P + 1 + j, 10 * n) for j in range(NEW - 1))
    got = spec.metric_reader("hybrid_step_mfu").read(record(generations()))
    assert got == pytest.approx(100.0 * want / 1.2)
    assert spec.metric_reader("hybrid_step_mfu").read(record(generations(False))) is None


def test_moe_expert_roofline_reads_the_counted_bound():
    """A segment of a B 8 and a B 5 generation (none of 5 in the window:
    the expectation), the grouped products' 3 launches a MoE layer and
    step, 1 ms each."""
    P, NEW, n = MIX["prompt_len"], MIX["new_tokens"], SHAPE["moe_layers"]
    launches = 3 * n * NEW * 2
    trace = DeviceTrace(0.0, 1.0, [(GROUPED + "x", 0.0, 1e-3)] * launches
                        + [("nvjet_tst_64x8", 0.0, 5e-3)])
    least = n * (X.expert_products_bound(SHAPE, 8 * P, 16)
                 + (NEW - 1) * X.expert_products_bound(SHAPE, 8, 10))
    E, k = SHAPE["n_experts"], SHAPE["top_k"]
    least += n * (X.expert_products_bound(SHAPE, 5 * P, yardstick.expected_experts(E, k, 5 * P))
                  + (NEW - 1) * X.expert_products_bound(SHAPE, 5,
                                                        yardstick.expected_experts(E, k, 5)))
    read = spec.metric_reader("moe_expert_roofline").read
    got = read(record(generations(), trace, gens=(8, 5)))
    assert got == pytest.approx(100.0 * least / (launches * 1e-3))
    assert read(record(generations(False), trace, gens=(8, 5))) is None
    assert read(record(generations(), trace, gens=(8,))) is None      # launches do not match
    assert read(record(generations())) is None                        # no trace


@pytest.mark.card
def test_traced_run_at_size_reports_the_new_readers(card):
    rc, res, err = run_cell(CELL, quick=False, trace=1, seconds=5.0, timeout=1200)
    assert rc == 0, err[-2000:]
    assert res["correct"] is True and res["device"]["kind"] == card
    for name in ("hybrid_step_mfu", "moe_expert_roofline"):
        assert 0.0 < res["metrics"][name]["value"] <= 105.0, name
