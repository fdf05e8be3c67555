"""The port's static analysis (``repro_torch.analysis``): the checker itself
is under test, as ``tests/test_contracts.py`` holds the reference's.

NO FALSE NEGATIVE: a seeded violation per rule — a materialized candidate
gather, a host sync, a data-dependent shape, a copy between devices, a
flush that copies its table, an int8 table rebuilt as fp32 or kept off
the kernels, a per-batch-size program blowup, a mirror write with no
dirty marking, an un-spanned clock charge, an over-budget kernel in a
``-Xptxas -v`` report — which its rule MUST flag and no other rule may.
NO FALSE POSITIVE: the real CPU hot paths for {flat, hnsw} x {fp32, int8},
the real delta flush, the sharded serve sweep, the shape families' shared
memory and the port's own modules come back clean; each lint fails on a
mutated copy of the real source. Also: an index loaded from the
reference's state uploads every row at its first sync (the reason its
loader's writes carry ``# mirror-ok``), and the ``check --device cpu`` gate
exits 0 on the tree and 1 on a seeded violation. Nothing is timed.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import hnsw as jhnsw
from repro_torch.analysis import check, mirror_lint, smem, span_lint
from repro_torch.analysis.contracts import (CompileCensus, DtypeDiscipline, InPlaceFlush,
                                            NoHostTransfer, OpTrace, build_index,
                                            collect_compile_census,
                                            collect_hot_path_traces, record_delta_flush,
                                            recording, run_rules)
from repro_torch.core import hnsw as H
from repro_torch.kernels import ops

D = 384
PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (pytest-xdist runs
    a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _trace(fn, *args, meta, name="synthetic") -> OpTrace:
    with recording() as rec:
        fn(*args)
    return OpTrace(name=name, ops=rec.ops, meta=meta)


def _rule_names(violations) -> set:
    return {v.rule for v in violations}


# ---------------------------------------------------------------------------
# No false negative: each seeded violation trips exactly its rule.
# ---------------------------------------------------------------------------

def test_flags_materialized_gather_and_only_that():
    """A search that expands candidates through a (B, K, d) gather — the
    tensor the fused hop exists to avoid."""
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(_unit(rng, 64))
    idx = torch.from_numpy(rng.integers(0, 64, (8, 16)))
    q = torch.from_numpy(_unit(rng, 8))

    def bad_search(emb, idx, q):
        rows = emb[idx]                          # (B, K, d) materialized
        return torch.einsum("bkd,bd->bk", rows, q)

    viols = run_rules([_trace(bad_search, emb, idx, q, meta={"B": 8, "K": 16, "d": D})])
    assert _rule_names(viols) == {"NoMaterializedGather"}
    assert "materialized" in viols[0].message and "[8, 16, 384]" in viols[0].message


def test_flags_host_sync_and_only_that():
    """An ``.item()`` spliced into a hot path: the host waits for the device."""
    viols = run_rules([_trace(lambda x: x * x.sum().item(), torch.ones(8), meta={"d": D})])
    assert _rule_names(viols) == {"NoHostTransfer"}
    assert "_local_scalar_dense" in viols[0].message


def test_flags_data_dependent_shape_and_only_that():
    """A boolean-mask selection and a nonzero: shapes only the host can learn."""
    x = torch.linspace(-1, 1, 16)
    viols = run_rules([_trace(lambda x: (x[x > 0], x.nonzero()), x, meta={"d": D})])
    assert _rule_names(viols) == {"NoHostTransfer"}
    assert len(viols) == 2 and all("data-dependent" in v.message for v in viols)


def test_flags_copy_between_devices_and_only_that():
    """A copy to another device inside a program ("meta" stands in for the
    card here); a declared upload passes."""
    x = torch.ones(8)
    t = _trace(lambda x: x.to("meta"), x, meta={"d": D})
    viols = run_rules([t])
    assert _rule_names(viols) == {"NoHostTransfer"}
    assert "copy between devices" in viols[0].message
    t.meta["uploads"] = 1
    assert NoHostTransfer().check(t) == []


def test_kernel_wrappers_are_opaque():
    """``ops.cache_topk`` on the CPU runs its plain version, which
    materializes (B, N) scores: the trace holds one opaque op and none of
    them, so no rule sees the plain version's work (the counterpart of
    the reference's whitelisted TopK custom call)."""
    rng = np.random.default_rng(1)
    table = torch.from_numpy(_unit(rng, 4096))
    valid = torch.ones(4096, dtype=torch.bool)
    q = torch.from_numpy(_unit(rng, 8))
    t = _trace(lambda: ops.cache_topk(table, valid, q), meta={"B": 8, "K": 1, "d": D})
    assert [op.name for op in t.ops] == ["kernel:cache_topk"]
    assert [i.shape for i in t.ops[0].inputs] == [(4096, D), (4096,), (8, D)]
    assert [o.shape for o in t.ops[0].outputs] == [(8,), (8,)]
    assert run_rules([t]) == []


def test_flags_copying_flush_and_only_that():
    """A 'delta flush' that clones the table and writes the clone: every
    sync copies O(capacity·d) bytes, and the mirror's storage changes."""
    table = torch.zeros((256, D))
    rows, vals = torch.arange(8), torch.ones((8, D))
    ptr = table.data_ptr()
    with recording() as rec:
        new = table.clone()
        new[rows] = vals
    t = OpTrace("flush", rec.ops, meta={"d": D, "capacity": 256, "tables": {"emb": (256, D)},
                                        "ptrs_before": {"emb": ptr},
                                        "ptrs_after": {"emb": new.data_ptr()}})
    viols = run_rules([t])
    assert _rule_names(viols) == {"InPlaceFlush"}
    assert any("new storage" in v.message for v in viols)
    assert any("whole table" in v.message for v in viols)


def test_flags_fp32_rematerialization_and_only_that():
    """A quantized 'search' that converts the whole int8 table to fp32
    before the dot — the silent 4x traffic DtypeDiscipline pins."""
    cap = 4096
    emb_q, scale = torch.zeros((cap, D), dtype=torch.int8), torch.ones(cap)
    q = torch.zeros((8, D))

    def bad_quant_search(emb_q, scale, q):
        table = emb_q.to(torch.float32) * scale[:, None]    # a full fp32 copy
        return q @ table.T

    t = _trace(bad_quant_search, emb_q, scale, q,
               meta={"d": D, "capacity": cap, "emb_dtype": "int8"})
    viols = run_rules([t])
    assert _rule_names(viols) == {"DtypeDiscipline"}
    assert any("materialization" in v.message for v in viols)


def test_flags_quantized_trace_with_no_int8_table():
    """A trace claiming int8 residency whose kernel scans an fp32 table: the
    control-plane table leaked onto the hot path."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(_unit(rng, 4096))
    t = _trace(lambda: ops.cache_topk(table, torch.ones(4096, dtype=torch.bool),
                                      torch.from_numpy(_unit(rng, 8))),
               meta={"d": D, "capacity": 4096, "emb_dtype": "int8"})
    viols = DtypeDiscipline().check(t)
    assert len(viols) == 2
    assert "hands no kernel the int8 table" in viols[0].message
    assert "float32 copy of the table" in viols[1].message


def test_flags_per_batch_compile_blowup():
    """Bucketing regressed: one program per batch size."""
    census = CompileCensus(name="sweep", families={"FlatIndex[float32] shard0": 5,
                                                   "FlatIndex[float32] shard1": 1})
    viols = run_rules([census])
    assert _rule_names(viols) == {"CompileBudget"}
    assert len(viols) == 1 and "shard0" in viols[0].message


def test_flags_mirror_write_without_dirty_marking():
    """A host-table write whose rows never reach the dirty log."""
    src = '''
class Index:
    def evict(self, slot):
        self.valid[slot] = False
        self.category[slot] = -1

    def good_evict(self, slot):
        self.valid[slot] = False
        self._dirty.add(slot)
'''
    viols = mirror_lint.lint_source(src, filename="synthetic.py")
    assert len(viols) == 1
    assert viols[0].target.endswith(":evict")
    assert "'category'" in viols[0].message and "'valid'" in viols[0].message


def test_mirror_lint_pragma_and_delegate_are_honored():
    src = '''
def quantize(self, slot, q):
    self.emb_q[slot] = q    # mirror-ok

def insert(self, vec):
    self.slot_inserted[3] = 1.0
    self.index.add_batch(vec)
'''
    assert mirror_lint.lint_source(src) == []


REPORT = """== frontier_hop.cu (rc 0)
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN11repro_torch19frontier_hop_kernelENS_7HopArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN11repro_torch19frontier_hop_kernelENS_7HopArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]
== gather_scores.cu (rc 0)
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120gather_scores_kernelILb1ELb0EEEvNS_10GatherArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120gather_scores_kernelILb1ELb0EEEvNS_10GatherArgsE
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 2048 bytes smem, 400 bytes cmem[0]
== scatter_rows.cu (rc 0)
ptxas info    : Function properties for _Z19scatter_rows_kernel12ScatterParams
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z19scatter_rows_kernel12ScatterParams' for 'sm_90a'
ptxas info    : Used 24 registers, 4096 bytes smem, 380 bytes cmem[0]
"""


def test_ptxas_parser_reads_report():
    ks = smem.parse_ptxas(REPORT)
    got = [(k.source, k.name, k.registers, k.smem_static, k.stack_bytes, k.spill_bytes)
           for k in ks]
    assert got == [("frontier_hop.cu", "frontier_hop_kernel", 40, 0, 0, 0),
                   ("gather_scores.cu", "gather_scores_kernel", 168, 2048, 16, 20),
                   ("scatter_rows.cu", "scatter_rows_kernel", 24, 4096, 0, 0)]
    assert smem.kernel_resources(ks, "gather_scores_masked") == {
        "registers": 168, "smem_static": 2048, "spill_bytes": 20}


def test_flags_over_budget_kernels():
    """168 registers × 512 threads past the SM's 65,536, a spill with no
    reason, and a static + dynamic shared memory past the block's limit —
    each flagged, the kernel within budget not."""
    ks = smem.parse_ptxas(REPORT)
    viols = smem.budget_violations(ks, 232_448, dynamic={"scatter_rows_kernel": 230_000})
    assert sorted((v.rule, v.target) for v in viols) == [
        ("RegisterBudget", "gather_scores.cu:gather_scores_kernel"),
        ("SharedMemoryBudget", "scatter_rows.cu:scatter_rows_kernel"),
        ("SpillBudget", "gather_scores.cu:gather_scores_kernel")]
    assert smem.budget_violations(ks[:1], 232_448) == []
    named = smem.budget_violations(ks, 232_448, spill_reasons={"gather_scores_kernel": "x"})
    assert "SpillBudget" not in _rule_names(named)


# ---------------------------------------------------------------------------
# No false positive: the real hot paths and modules are clean.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype", [
    ("flat", "float32"), ("flat", "int8"), ("hnsw", "float32"), ("hnsw", "int8")])
def test_real_hot_paths_clean(kind, dtype):
    traces = collect_hot_path_traces(kind, dtype)
    assert len(traces) == 2                  # the search and the delta flush
    assert run_rules(traces) == []
    search, flush = traces
    kernels = [op.name for op in search.ops if op.kernel]
    if kind == "flat":
        assert kernels == ["kernel:cache_topk"]
    else:                                    # the entry set, then max_hops hops
        assert kernels == ["kernel:hop_scores"] + ["kernel:frontier_hop"] * 4
    assert [op.name for op in flush.ops if op.kernel] == ["kernel:scatter_flush"]
    want = "int8" if dtype == "int8" else "float32"
    assert all(op.inputs[0].dtype == want for op in search.ops if op.kernel)


def test_real_delta_flush_is_in_place():
    """Positive control for InPlaceFlush: the real flush keeps every table's
    storage, and moves its delta in its declared uploads."""
    idx = build_index("hnsw", "float32", capacity=256)
    t = record_delta_flush(idx)
    assert t.meta["ptrs_before"] == t.meta["ptrs_after"]
    assert t.meta["uploads"] == 2            # the packed delta and the entry set
    assert InPlaceFlush().check(t) == [] and NoHostTransfer().check(t) == []


def test_real_serve_sweep_compiles_once_per_shard():
    from repro_torch.core.policy import CategoryConfig, PolicyEngine
    from repro_torch.core.shard import ShardedSemanticCache
    pol = PolicyEngine([CategoryConfig("a", threshold=0.85, ttl=1e6, quota=0.5),
                        CategoryConfig("b", threshold=0.80, ttl=1e6, quota=0.5)])
    cache = ShardedSemanticCache(pol, dim=48, capacity=64, n_shards=2, index_kind="flat",
                                 use_device=True, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    cache.insert_batch(_unit(rng, 6, 48), ["a", "b"] * 3, [f"q{i}" for i in range(6)],
                       [f"r{i}" for i in range(6)])
    census = collect_compile_census(cache, batches=(1, 2, 3, 5, 8))
    assert len(census.families) == 2
    assert run_rules([census]) == []


def test_shape_families_fit_the_h100_shared_memory():
    """Every launch of the reference's shape families asks for dynamic
    shared memory within the H100's opt-in limit per block (232,448 bytes),
    by the launches' own formulas."""
    sizes = [smem.dynamic_smem(k, shape, dt) for k, shape in smem.SHAPE_FAMILIES
             for dt in smem.DTYPES]
    assert len(sizes) == 30 and max(sizes) <= 232_448
    assert smem.dynamic_smem("frontier_hop", {"M": 32}, "float32") == 51_344


def test_real_core_modules_pass_mirror_lint():
    assert [p.name for p in mirror_lint.default_paths()] == ["hnsw.py", "cache.py",
                                                             "shard.py"]
    assert all(str(p).startswith(str(PORT)) for p in mirror_lint.default_paths())
    assert mirror_lint.lint_paths() == []


def test_mirror_lint_fails_on_the_port_without_its_pragmas():
    src = (PORT / "core" / "hnsw.py").read_text().replace("# mirror-ok", "#")
    viols = mirror_lint.lint_source(src, filename="hnsw.py")
    assert sorted(v.target for v in viols) == ["hnsw.py:_load_common",
                                               "hnsw.py:_quantize_slot"]


def test_real_traced_modules_pass_span_lint():
    assert [p.name for p in span_lint.default_paths()] == ["cache.py", "shard.py",
                                                           "storage.py", "simulator.py"]
    assert span_lint.lint_paths() == []


def test_span_lint_fails_on_the_port_without_its_pragmas():
    src = (PORT / "core" / "storage.py").read_text().replace("# span-ok", "#")
    viols = span_lint.lint_source(src, filename="storage.py")
    assert viols and all(v.rule == "SpanCoverage" for v in viols)
    src = (PORT / "core" / "cache.py").read_text().replace("._span(", "._nospan(")
    assert span_lint.lint_source(src, filename="cache.py")


GOOD_SRC = '''
class C:
    def charged(self):
        with self._span("search"):
            self.clock.advance(0.001)
'''

BAD_SRC = '''
class C:
    def charged(self):
        self.clock.advance(0.001)
'''

PRAGMA_SRC = '''
class C:
    def charged(self):
        self.clock.advance(0.001)  # span-ok: caller-owned span
'''

PRAGMA_ABOVE_SRC = '''
class C:
    def charged(self):
        # span-ok: inter-arrival idle
        self.clock.advance(self.t - self.clock.now())
'''


class TestSpanLint:
    def test_spanned_charge_passes(self):
        assert span_lint.lint_source(GOOD_SRC) == []

    def test_unspanned_charge_flagged(self):
        out = span_lint.lint_source(BAD_SRC, filename="x.py")
        assert len(out) == 1
        assert out[0].rule == "SpanCoverage"
        assert "x.py:charged" in out[0].target

    def test_pragma_on_line_or_above_passes(self):
        assert span_lint.lint_source(PRAGMA_SRC) == []
        assert span_lint.lint_source(PRAGMA_ABOVE_SRC) == []

    def test_recorder_span_call_counts(self):
        src = GOOD_SRC.replace("self._span", "rec.span")
        assert span_lint.lint_source(src) == []


# ---------------------------------------------------------------------------
# The loader's pragmas rest on this: a loaded index uploads every row first.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype", [
    ("flat", "float32"), ("flat", "int8"), ("hnsw", "float32"), ("hnsw", "int8")])
def test_loaded_index_first_sync_is_full_upload(kind, dtype):
    """``index_from_reference`` fills a new index's tables with writes its
    dirty log does not cover (it carries the reference's log: here the rows
    of one insert). Its first ``device_tables()`` must be a full upload, so every
    loaded row reaches the device."""
    rng = np.random.default_rng(3)
    if kind == "flat":
        ref = jhnsw.FlatIndex(48, 64, emb_dtype=dtype)
    else:
        ref = jhnsw.HNSWIndex(48, 64, params=jhnsw.HNSWParams(M=4, M0=8, emb_dtype=dtype),
                              seed=0)
    ref.add_batch(_unit(rng, 20, 48), np.arange(20) % 3)
    ref.device_tables()
    ref.add_batch(_unit(rng, 1, 48), np.zeros(1, np.int32))
    state = H.reference_state(ref)
    assert 0 < len(state["_dirty"]) < 21           # fewer than the loaded rows
    idx = (H.flat_index_from_reference(state, device="cpu") if kind == "flat"
           else H.index_from_reference(state, device="cpu"))
    tables = idx.device_tables()
    st = idx.sync_stats
    assert (st["full_uploads"], st["delta_updates"], st["rows_synced"]) == (1, 0, 64)
    for name, host in idx._host_tables().items():
        np.testing.assert_array_equal(tables[name].numpy(), host, err_msg=name)
    if dtype == "int8":
        assert tables["emb"].dtype == torch.int8 and np.abs(idx.emb_q).sum() > 0


# ---------------------------------------------------------------------------
# The gate.
# ---------------------------------------------------------------------------

def test_check_cli_passes_on_the_tree(capsys):
    assert check.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "OK: every section run holds on cpu (1 not run: Kernel budgets" in out
    assert "needs the card" in out


def test_check_cli_fails_on_a_seeded_violation(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "hnsw.py"
    bad.write_text((PORT / "core" / "hnsw.py").read_text().replace("# mirror-ok", "#"))
    monkeypatch.setattr(mirror_lint, "default_paths", lambda: [bad])
    monkeypatch.setattr(check, "SECTIONS", tuple(s for s in check.SECTIONS
                                                 if s[1] is not check.check_compile_budget))
    assert check.main(["--device", "cpu", "-q"]) == 1
    err = capsys.readouterr().err
    assert "FAIL: 2 contract violation(s)" in err and "hnsw.py:_quantize_slot" in err


def test_check_cli_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        check.main([])
