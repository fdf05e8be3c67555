"""Sharded serving of the hybrid, encdec and vlm families against the
reference's meshed run, on 4 gloo CPU ranks (the harness of
``test_torch_dist_serve.py``, ``tests/_dist_serve.py``).

On (data 2, model 2), fp32, a prefill of 12 tokens and 4 teacher-forced
decode steps, at B 8 (batch over ``data``, heads over ``model``) and B 3
(every rank all rows, the KV sequence over (data, model)):

* reduced jamba-v0.1-52b, its 8-layer period: Mamba layers with their
  state's channels over ``model``, an attention layer, and MoE layers
  whose dispatch (EP or dense) is the reference's per layer and call;
* reduced whisper-large-v3 (2 layers): the encoder under tensor
  parallelism, each layer's cross K/V in the cache with every head
  (``enc_kv_spec``), each model rank's cross-attention on its heads;
* reduced llava-next-mistral-7b (2 layers): its 8 patches prepended, the
  cache sized for them.

Each held to: every step's gathered logits within 1e-4 of the
reference's, the gathered cache (cross K/V included) within 1e-4.
"""

import pytest
import torch
from _dist_serve import case_ids, check_case, run_reference, serve_case

from repro_torch.launch.mesh import launch_ranks

CASES = [(name, B, (2, 2), {}) for name in
         ("jamba_v0_1_52b", "whisper_large_v3", "llava_next_mistral_7b") for B in (8, 3)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (pytest-xdist runs
    a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank(rank, world, cases, refs):
    from repro_torch.distributed.context import Dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist = Dist.from_mesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    out = {"cases": []}
    for (name, B, _, over), ref in zip(cases, refs):
        res = serve_case(dist, name, B, over, ref)
        out["cases"].append(res if rank == 0 else {"logits": res["logits"]})
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, tmp_path_factory.mktemp("reference") / "out.pkl")


@pytest.fixture(scope="module")
def ranks(reference):
    return launch_ranks(_rank, 4, backend="gloo", device="cpu", timeout=300,
                        args=(CASES, reference))


@pytest.mark.parametrize("i", range(len(CASES)), ids=case_ids(CASES))
def test_meshed_serving_matches_reference(reference, ranks, i):
    name, _, _, over = CASES[i]
    check_case(reference[i], ranks, i, name, over)
    if name.startswith("jamba"):
        assert "ep" in reference[i]["dispatch"]["prefill"]
