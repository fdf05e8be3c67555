"""repro_torch's train step and fault-tolerant train loop, on the CPU:
the step and ``run_training`` against the JAX reference from the same
weights, resume against an uninterrupted run, the emergency checkpoint on
preemption, ``retry_step`` and its backoff on a ``SimClock``, and the CLI.

Reduced llama3.2-3b at 2 layers, d 64, vocab 256 (the reference's own
fault tests' size; fp32 where it is compared with the reference, the
config's bf16 elsewhere), B 2-4, S 32. The reference runs with P kept in fp32
(``_exact_attention``; see ``test_torch_train.py``). Tolerances: losses
and gradient norms within 1e-4 relative; parameters within 1e-3 · lr per
step taken, but for at most 1 in 1,000 elements, which must be within
2 · lr per step: where a gradient element is as small as Adam's ε (1e-8),
m̂/(√v̂ + ε) turns on the rounding of that element, and one step moves it
by anything up to lr (measured: 3 of 37,056 elements, each with |g| ≈
2e-8 at the first step, 1.2e-2 · lr apart). On the CPU the port is
deterministic, so a resumed run equals the uninterrupted one bit for bit
(the reference's own test allows 2e-2).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models.attention as jattn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.launch.train import run_training as jrun_training  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import init_opt_state as jinit_opt_state  # noqa: E402

import repro_torch.distributed.fault as fault  # noqa: E402
from _exact_attention import attend_prefill_exact  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.clock import SimClock  # noqa: E402
from repro_torch.data import PackedBatcher, SyntheticCorpus  # noqa: E402
from repro_torch.distributed.fault import PreemptionHandler, retry_step  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_reference, tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_layers=2, d_model=64, vocab_size=256)
F32 = dict(SMALL, dtype="float32")          # the parity tests' models
quiet = lambda *_: None  # noqa: E731


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (see
    ``tests/test_torch_shard.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def exact_reference_attention():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "attend_prefill", attend_prefill_exact)
        yield


def ref_params(cfg, seed=0):
    return JModel(jget_config("llama3_2_3b").reduced(**F32, grad_accum=cfg.grad_accum)
                  ).init_params(jax.random.key(seed))


def assert_params_close(tp, jp, cfg, lr, steps):
    want = tree_leaves(params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu"))
    err = torch.cat([(g.detach() - w).abs().flatten() for g, w in zip(tree_leaves(tp), want)])
    assert float((err > 1e-3 * lr * steps).float().mean()) <= 1e-3
    assert float(err.max()) <= 2 * lr * steps


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum, exact_reference_attention):
    cfg = get_config("llama3_2_3b").reduced(**F32, grad_accum=grad_accum)
    jm = JModel(jget_config("llama3_2_3b").reduced(**F32, grad_accum=grad_accum))
    jp = ref_params(cfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jmake_train_step(jm, JAdamWConfig(**kw)))
    tstep = make_train_step(Model(cfg, device="cpu"), AdamWConfig(**kw))
    jst, tst = jinit_opt_state(jp, JAdamWConfig(**kw)), init_opt_state(tp, AdamWConfig(**kw))
    batcher = PackedBatcher(SyntheticCorpus(cfg.vocab_size, seed=1), 4, 32)
    for _ in range(3):
        batch = batcher.next_batch()
        jp, jst, jmet = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tmet = tstep(tp, tst, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-4)
        assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    assert int(tst["step"]) == 3
    assert_params_close(tp, jp, cfg, kw["lr"], 3)


def test_run_training_matches_reference(exact_reference_attention):
    """``run_training(params=...)`` from the reference's initial weights
    (``jax.random.key(0)``, what its own ``run_training`` draws) against
    the reference's ``run_training``: the same batches, the same losses."""
    cfg = get_config("llama3_2_3b").reduced(**F32)
    jcfg = jget_config("llama3_2_3b").reduced(**F32)
    start = params_from_reference(jax.tree.map(np.asarray, ref_params(cfg)), cfg, "cpu")
    kept = [t.clone() for t in tree_leaves(start)]
    got = run_training(cfg, steps=4, batch=2, seq=32, lr=1e-3, log=quiet, device="cpu",
                       params=start)
    want = jrun_training(jcfg, steps=4, batch=2, seq=32, lr=1e-3, log=quiet)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(kept, tree_leaves(start)))  # copied
    assert_params_close(got["params"], want["params"], cfg, 1e-3, 4)


def test_serving_head_follows_in_place_training():
    """The serving path's fp32 head copy is made anew after the optimizer
    updates the head in place (the same tensor, a new version)."""
    cfg = get_config("llama3_2_3b").reduced(**SMALL)
    model = Model(cfg, device="cpu")
    params = model.init_params(0)
    before = model._head(params).clone()
    step = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=1))
    batch = PackedBatcher(SyntheticCorpus(cfg.vocab_size), 2, 32).next_batch()
    step(params, init_opt_state(params, AdamWConfig()),
         {k: torch.from_numpy(v) for k, v in batch.items()})
    after = model._head(params)
    assert torch.equal(after, params["head"].detach().float())
    assert not torch.equal(after, before)


def test_train_resume_matches_uninterrupted(tmp_path):
    """checkpoint/restart: 6 straight steps == 3 steps + restart + 3."""
    cfg = get_config("llama3_2_3b").reduced(**SMALL)
    r_full = run_training(cfg, steps=6, batch=2, seq=32, log=quiet, device="cpu")
    d = str(tmp_path / "ck")
    run_training(cfg, steps=3, batch=2, seq=32, ckpt_dir=d, ckpt_every=100, log=quiet,
                 device="cpu")
    assert latest_step(d) == 3
    r_resumed = run_training(cfg, steps=6, batch=2, seq=32, ckpt_dir=d, ckpt_every=100,
                             log=quiet, device="cpu")
    assert r_resumed["steps_run"] == 3       # resumed from step 3
    assert r_full["losses"][3:] == r_resumed["losses"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r_full["params"]),
                                                 tree_leaves(r_resumed["params"])))


def test_preemption_triggers_emergency_checkpoint(tmp_path, monkeypatch):
    """SIGTERM-style preemption mid-run → checkpoint written + clean exit."""
    cfg = get_config("llama3_2_3b").reduced(**SMALL)
    install = PreemptionHandler.install

    def install_and_fire(self):
        install(self)
        self.trigger_for_test()
        return self
    monkeypatch.setattr(fault.PreemptionHandler, "install", install_and_fire)
    res = run_training(cfg, steps=50, batch=2, seq=32, ckpt_dir=str(tmp_path),
                       ckpt_every=1000, log=quiet, device="cpu")
    assert res["steps_run"] == 1          # stopped at the first boundary
    assert latest_step(str(tmp_path)) == 1


def test_preemption_flag_via_trigger():
    h = PreemptionHandler().install()
    assert not h.preempted
    h.trigger_for_test()
    assert h.preempted
    h.uninstall()


def test_retry_step_retries_then_raises():
    calls = []

    def flaky():
        calls.append(1)
        raise RuntimeError("transient")

    with pytest.raises(RuntimeError):
        retry_step(flaky, retries=2)
    assert len(calls) == 3
    attempts = []

    def ok_after_one(x):
        attempts.append(1)
        if len(attempts) < 2:
            raise RuntimeError("CUDA error: an illegal memory access")
        return x

    seen = []
    assert retry_step(ok_after_one, "fine", on_retry=lambda a, e: seen.append(a)) == "fine"
    assert seen == [0]
    with pytest.raises(ValueError):       # not a device error: no retry
        retry_step(lambda: (_ for _ in ()).throw(ValueError("bad")), retries=3)


def test_retry_backoff_is_charged_to_the_clock():
    clock = SimClock()

    def flaky():
        raise RuntimeError("transient")

    with pytest.raises(RuntimeError):
        retry_step(flaky, retries=3, backoff_s=0.5, clock=clock)
    assert clock.now() == pytest.approx(0.5 + 1.0 + 2.0)   # no wait after the last


def test_training_runs_on_the_card_unless_told_otherwise():
    """``device=None`` is the card; on a machine without one it raises, it
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(get_config("llama3_2_3b").reduced(**SMALL), steps=1, batch=2,
                     seq=32, log=quiet)


def test_cli_runs_and_its_loss_falls(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-3b",
         "--reduced", "--steps", "20", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "10"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    done = [line for line in out.stdout.splitlines() if "done:" in line][-1]
    fields = dict(kv.split("=") for kv in done.split("done: ")[1].split())
    assert int(fields["steps"]) == 20
    assert float(fields["final_loss"]) < float(fields["first_loss"]), done
    assert latest_step(str(tmp_path / "ck")) == 20
