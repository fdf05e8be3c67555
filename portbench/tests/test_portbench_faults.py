"""A run with its timed path broken underneath must come out not
correct: a generated token altered where the engine produces it, the
decode state returned unchanged, a cache hit's answer altered, half of
each step's requests never answered, the write-back storing nothing.
Both configurations: each compares its own model number."""

import pytest

from pbhelp import run_cell


MODEL_NUMBER = {"falcon-mamba-7b.head_warm": "logit_gap",
                "granite-moe-3b-a800m.head_warm": "logit_gap_mean"}


@pytest.mark.parametrize("workload", sorted(MODEL_NUMBER))
@pytest.mark.parametrize("fault", ["token", "stale", "answer", "drop", "insert"])
def test_fault_turns_correct_false(workload, fault):
    number = {"answer": "answer_mismatches", "drop": "unanswered",
              "insert": "writeback_errors"}.get(fault, MODEL_NUMBER[workload])
    rc, res, err = run_cell(workload, fault=fault, seconds=2.0)
    assert rc == 0, err[-2000:]
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
