"""repro_torch's checkpoints: atomic save / restore, GC, async, the
snapshot taken at ``save()``, and the on-disk format shared with the JAX
reference (each package restores the other's checkpoints with equal
arrays, bf16 included). Arrays compare bit for bit."""

import os
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402

import repro_torch.checkpoint.checkpoint as ckmod  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.models.convert import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (see
    ``tests/test_torch_shard.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(rng):
    """Params with a list of layers (the port's layout), bf16 and fp32
    leaves, and an int8 optimizer state with a scalar step."""
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    params = {"embed": f(4, 128).to(torch.bfloat16),
              "layers": [{"w": f(128, 128).to(torch.bfloat16), "ln": f(128)} for _ in range(3)],
              "final_norm": f(128)}
    return {"params": params, "opt": init_opt_state(params, AdamWConfig(state_dtype="int8"))}


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if a is None:
        return b is None
    return a.dtype == b.dtype and torch.equal(a, b)


def drop_none(tree):
    """The tree as a checkpoint holds it: None leaves (an fp32 moment's
    scale) are not stored."""
    if isinstance(tree, dict):
        return {k: drop_none(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, list):
        return [drop_none(v) for v in tree]
    return tree


def test_save_restore_roundtrip(tmp_path, rng):
    tree = make_tree(rng)
    path = save_checkpoint(str(tmp_path), 5, tree, extras={"foo": 1})
    assert os.path.basename(path) == "step_000000005"
    got, extras, step = restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 5 and extras == {"foo": 1}
    assert isinstance(got["params"]["layers"], list)
    assert same(drop_none(tree), got)
    assert got["params"]["embed"].dtype == torch.bfloat16     # bf16 survives
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].dim() == 0


def test_latest_and_gc(tmp_path, rng):
    tree = make_tree(rng)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree, keep=3)
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "absent")) is None
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_000000003", "step_000000004", "step_000000005"]
    got, _, step = restore_checkpoint(str(tmp_path), step=4, device="cpu")
    assert step == 4 and same(drop_none(tree), got)


def test_async_checkpointer(tmp_path, rng):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    tree = make_tree(rng)
    ck.save(1, tree)
    ck.save(2, tree)      # waits for 1 internally
    ck.wait()
    assert latest_step(str(tmp_path)) == 2
    assert sorted(os.listdir(tmp_path)) == ["step_000000001", "step_000000002"]


def test_snapshot_survives_in_place_mutation(tmp_path, rng, monkeypatch):
    """``save`` copies to host before it returns: the optimizer's in-place
    update of the next step, made while the writer thread runs, is not in
    the file (the writer thread is held until the mutation is done)."""
    tree = make_tree(rng)
    want = [leaf.clone() for leaf in tree_leaves(tree["params"])]
    mutated = threading.Event()
    write = ckmod._write

    def write_after_the_next_step(*args):
        assert mutated.wait(timeout=30)
        return write(*args)
    monkeypatch.setattr(ckmod, "_write", write_after_the_next_step)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, tree)
    for leaf in tree_leaves(tree["params"]):
        leaf.add_(1.0)                                  # the next step, in place
    mutated.set()
    ck.wait()
    got, _, _ = restore_checkpoint(str(tmp_path), device="cpu")
    assert all(same(w, g) for w, g in zip(want, tree_leaves(got["params"])))


def test_failed_write_surfaces_on_wait(tmp_path, rng):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, make_tree(rng))
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                        # the error is raised once


def test_reference_checkpoint_restores_in_port(tmp_path, rng):
    jtree = {"params": {"w": jnp.asarray(rng.standard_normal((4, 8)), jnp.bfloat16),
                        "b": jnp.asarray(rng.standard_normal(8), jnp.float32),
                        "stack": {"sub0": {"wq": jnp.asarray(rng.standard_normal((2, 8, 4)),
                                                             jnp.bfloat16)}}},
             "opt": {"step": jnp.asarray(7, jnp.int32),
                     "q": jnp.asarray(rng.integers(-127, 128, (2, 128)), jnp.int8)}}
    jsave(str(tmp_path), 9, jtree, extras={"batcher": {"doc_cursor": 4, "carry": [1, 2]}})
    got, extras, step = restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 9 and extras["batcher"]["carry"] == [1, 2]
    for leaf, want in ((got["params"]["w"], jtree["params"]["w"]),
                       (got["params"]["b"], jtree["params"]["b"]),
                       (got["params"]["stack"]["sub0"]["wq"],
                        jtree["params"]["stack"]["sub0"]["wq"]),
                       (got["opt"]["step"], jtree["opt"]["step"]),
                       (got["opt"]["q"], jtree["opt"]["q"])):
        want = np.asarray(want)
        assert str(leaf.dtype).removeprefix("torch.") == want.dtype.name
        assert leaf.shape == want.shape
        if want.dtype.name == "bfloat16":
            assert np.array_equal(leaf.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
        else:
            assert np.array_equal(leaf.numpy(), want)


def test_port_checkpoint_restores_in_reference(tmp_path, rng):
    tree = make_tree(rng)
    save_checkpoint(str(tmp_path), 2, tree, extras={"k": "v"})
    jtree, extras, step = jrestore(str(tmp_path))
    assert step == 2 and extras == {"k": "v"}
    # the reference reads the list of layers as a dict keyed "0", "1", "2"
    for i, layer in enumerate(tree["params"]["layers"]):
        jw = np.asarray(jtree["params"]["layers"][str(i)]["w"])
        assert jw.dtype == jnp.bfloat16
        assert np.array_equal(jw.view(np.uint16),
                              layer["w"].view(torch.int16).numpy().view(np.uint16))
        assert np.array_equal(np.asarray(jtree["params"]["layers"][str(i)]["ln"]),
                              layer["ln"].numpy())
    m = tree["opt"]["m"]["embed"]
    assert np.array_equal(np.asarray(jtree["opt"]["m"]["embed"]["q"]), m["q"].numpy())
    assert np.array_equal(np.asarray(jtree["opt"]["m"]["embed"]["s"]), m["s"].numpy())
    assert int(np.asarray(jtree["opt"]["step"])) == 0
