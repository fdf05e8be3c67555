"""The plain references: the cache reference's judgement of a fixed small
trace, the model references against the port's own function in fp32,
the controls at the quick size, and the yardstick's arithmetic."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbhelp import ROOT, SRC

sys.path[:0] = [str(ROOT), str(SRC)]

from portbench import spec, yardstick  # noqa: E402
from portbench.reference.cache import WRONG, ReferenceCache, round_bf16  # noqa: E402

POL = {"a": {"threshold": 0.9, "ttl": 10.0, "quota": 0.5, "allow_caching": True},
       "b": {"threshold": 0.8, "ttl": 100.0, "quota": 0.5, "allow_caching": True},
       "x": {"threshold": 0.9, "ttl": 1.0, "quota": 0.0, "allow_caching": False}}


def unit(*v):
    v = np.asarray(v + (0.0,) * (4 - len(v)), np.float32)
    return v / np.linalg.norm(v)


def test_cache_reference_judges_a_fixed_trace():
    rc = ReferenceCache(POL, capacity=16, dim=4)
    e0 = rc.insert("a", unit(1, 0), 0.0, "r0")
    e1 = rc.insert("b", unit(0, 1), 0.0, "r1")
    assert (e0, e1) == (0, 1)
    q = np.stack([unit(1, 0.1), unit(1, 0.1), unit(0.1, 1), unit(0, 0, 1), unit(1, 0)])
    cats = ["a", "b", "b", "a", "x"]
    # the exact search's own decisions
    dec = rc.decide(q, cats, 1.0)
    assert [(d["hit"], d["reason"], d["doc_id"]) for d in dec] == [
        (True, "hit", 0), (False, "no_match", -1), (True, "hit", 1),
        (False, "no_match", -1), (False, "compliance", -1)]
    # judged as a cache's answers: a right hit, a hit on another category's
    # entry, a text that is not the stored one, a miss where a hit was due
    s0 = float(unit(1, 0.1) @ unit(1, 0))
    answers = [dict(hit=True, reason="hit", doc_id=0, score=s0),
               dict(hit=True, reason="hit", doc_id=0, score=0.99),
               dict(hit=True, reason="hit", doc_id=1, score=float(unit(0.1, 1) @ unit(0, 1))),
               dict(hit=False, reason="no_match", doc_id=-1, score=0.0),
               dict(hit=False, reason="compliance", doc_id=-1, score=0.0)]
    j = rc.judge_batch(q, cats, 1.0, answers, ["r0", "r0", "other", "g3", "g4"])
    assert j["gap"][0] < 1e-6 and j["gap"][1] == WRONG and j["gap"][3:] == [0.0, 0.0]
    assert j["mismatch"] == [False, False, True, False, False]
    assert j["false_miss"] == [False, False, False, False, False]
    # the step's one miss of a cached category went in after its lookups
    assert rc.cat[2:] == ["a"] and rc.response[2:] == ["g3"]
    # a score read off by more than rounding is a gap
    j = rc.judge_batch(q[:1], ["a"], 2.0, [dict(hit=True, reason="hit", doc_id=0,
                                               score=s0 + 1e-3)], ["r0"])
    assert abs(j["gap"][0] - 1e-3) < 1e-6


def test_cache_reference_ttl_and_false_miss():
    rc = ReferenceCache(POL, capacity=16, dim=4)
    rc.insert("a", unit(1, 0), 0.0, "r0")
    q = unit(1, 0.05)[None]
    # past the TTL: a hit is wrong, an expiry evicts, and a miss is counted
    assert rc.decide(q, ["a"], 11.0)[0]["reason"] == "expired"
    assert rc.judge_batch(q, ["a"], 11.0, [dict(hit=True, reason="hit", doc_id=0,
                                               score=0.99)], ["r0"])["gap"] == [WRONG]
    rc2 = ReferenceCache(POL, capacity=16, dim=4)
    rc2.insert("a", unit(1, 0), 0.0, "r0")
    j = rc2.judge_batch(q, ["a"], 1.0, [dict(hit=False, reason="no_match", doc_id=-1,
                                             score=0.0)], ["g"])
    assert j["gap"] == [0.0] and j["false_miss"] == [True]
    j = rc2.judge_batch(q, ["a"], 20.0, [dict(hit=False, reason="expired", doc_id=-1,
                                              score=0.0)], ["g2"])
    assert j["gap"] == [0.0] and not rc2.live[1] and rc2.live[0]   # the best expired entry goes


def test_bf16_rounding():
    x = np.array([1.0, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9, -3.14159], np.float32)
    assert np.array_equal(round_bf16(x), torch.tensor(x).bfloat16().float().numpy())


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "granite-moe-3b-a800m"])
def test_model_reference_is_the_ports_function(name):
    """In fp32 on both sides the plain reference and the port's model give
    the same logits (the references import nothing of the port; this
    test does)."""
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model import Model
    cfg = spec.quick(spec.config(name))
    ref = spec.reference(cfg)
    params = ref.make_weights(cfg, 3, "cpu")

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        if isinstance(t, list):
            return [f32(v) for v in t]
        return t.float()
    p32 = f32(params)
    model = Model(ArchConfig(**{**cfg["port"], "dtype": "float32"}), device="cpu")
    toks = torch.randint(2, cfg["vocab_size"], (2, 12), generator=torch.Generator().manual_seed(0))
    got, _, _ = model.prefill(p32, {"tokens": toks}, 16)
    want = ref.logits(p32, cfg, toks, 11)[:, 0]
    assert float((got[:, :cfg["vocab_size"]] - want).abs().max()) < 1e-4


def test_controls_fail_where_the_program_passes():
    """The controls at the quick size: the program passes its limits, the
    fp8 reference in the model's place and the bf16 cache reference in the
    cache's fail them."""
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "control.py"), "--workload",
                        "falcon-mamba-7b.head_warm", "--seeds", "2147483651", "--seconds", "2",
                        "--quick"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-2000:]
    row = json.loads(p.stdout.strip().splitlines()[-1])
    limits = json.loads((ROOT / "portbench" / "limits" /
                         "falcon-mamba-7b.head_warm.json").read_text())
    prog, ctl = row["program"], row["control"]
    assert prog["logit_gap"] <= limits["quick"]["logit_gap"] < ctl["gaps"]["max"]
    assert prog["hit_gap"] <= limits["hit_gap"] < ctl["hit_gap"]


def test_decode_bound_matches_the_recorded_one():
    """falcon-mamba-7b's decode step at B 8: 4.24 ms by the bytes
    (PERF.md, chip_smoke's bound at the serve shapes)."""
    cfg = spec.config("falcon-mamba-7b")
    shape = spec.reference(cfg).step_shape(cfg)
    t = yardstick.step_bound(shape, 8, 1, 72)
    assert 4.1e-3 < t < 4.4e-3
    assert yardstick.expected_experts(40, 8, 8) == pytest.approx(33.29, abs=0.01)
