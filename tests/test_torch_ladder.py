"""The brute-force ladder of the PyTorch port (v0-v3, v5-v7) against the JAX
package, on CPU torch (the plain versions). Numpy makes each seeded input
once and both packages get the same arrays. The JAX side runs its own
functions, its Pallas kernels in interpret mode, as tests/test_bruteforce.py
runs them.

Tolerance: index arrays exactly equal, per version (assert_same_idx). The
plain versions and the f64 oracle also agree on every case (assert_exact).
"""

import ctypes
import glob
import os
import re

import numpy as np
import pytest
import torch

import nns_tpu
import nns_tpu.kernels.pallas_fused as jax_fused
import nns_tpu_torch
from conftest import assert_exact
from nns_tpu.config import EngineConfig as JaxEngineConfig
from nns_tpu.data import make_dataset
from nns_tpu_torch.config import EngineConfig
from nns_tpu_torch.kernels import _cuda, fused_ladder, layouts, xla_bruteforce
from nns_tpu_torch.kernels.fused import FusedBruteForce, fused_min_idx_plain, prepare_refs
from test_fuzz import _random_case
from test_torch_fused import assert_same_idx

LADDER = [0, 1, 2, 3, 5, 6, 7]
TILED = {  # the port's tiled rungs and the JAX functions they mirror
    3: (lambda q, r: fused_ladder.nns_fused_point_major(q, r, device="cpu"),
        lambda q, r: jax_fused.nns_fused_point_major(q, r, tile_m=8, tile_n=128)),
    5: (lambda q, r: fused_ladder.nns_fused_streaming(q, r, tile_n=128, device="cpu"),
        lambda q, r: jax_fused.nns_fused_streaming(q, r, tile_m=8, tile_n=128)),
    6: (lambda q, r: fused_ladder.nns_fused_queries_resident(q, r, device="cpu"),
        lambda q, r: jax_fused.nns_fused_queries_resident(q, r, tile_n=128)),
    7: (lambda q, r: fused_ladder.nns_two_level(q, r, tile_n=128, device="cpu"),
        lambda q, r: jax_fused.nns_two_level(q, r, tile_m=8, tile_n=128)),
}


def _both(q, r, version, port_cfg=None, jax_cfg=None):
    got = nns_tpu_torch.nns(q, r, version=version, config=port_cfg, device="cpu")
    want = np.asarray(nns_tpu.nns(q, r, version=version, config=jax_cfg))
    assert got.dtype == np.int32 and got.shape == (q.shape[0],)
    assert_same_idx(got, want, q, r)
    return got


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("version", LADDER)
def test_ladder_equals_jax_on_grid(version, case, grid_datasets):
    k, m, n, q, r = grid_datasets[case]
    assert_exact(_both(q, r, version), q, r)


@pytest.mark.parametrize("k,m,n", [(5, 33, 777), (3, 300, 5000), (16, 17, 1000)])
@pytest.mark.parametrize("version", LADDER)
def test_ladder_equals_jax_unaligned(version, k, m, n):
    q, r = make_dataset(k, m, n, seed=m + n)
    _both(q, r, version)


@pytest.mark.parametrize("version", sorted(TILED))
def test_lowest_index_tie_across_tiles(version):
    # Duplicates of the query point in different 128-column ref tiles
    # (test_bruteforce.py:46-57): the lowest index wins in both packages.
    rng = np.random.default_rng(0)
    r = rng.random((600, 3), dtype=np.float32)
    target = np.array([0.25, 0.5, 0.75], dtype=np.float32)
    for dup in (17, 300, 599):
        r[dup] = target
    q = np.concatenate([target[None], rng.random((12, 3), dtype=np.float32)])
    port, jax = TILED[version]
    got = port(q, r).numpy()
    assert_same_idx(got, np.asarray(jax(q, r)), q, r)
    assert got[0] == 17


def test_two_level_table_keeps_lowest_tile():
    # Equal minima in tiles 0 and 2 of the table: the second reduce takes
    # tile 0's index, and a replica-padded tail never enters the table.
    r = np.random.default_rng(1).random((300, 3), dtype=np.float32)
    r[5] = r[260] = 0.5
    q = torch.full((2, 3), 0.5)
    r_dm, _ = prepare_refs(r, 128, "cpu")
    part_d, part_i = fused_ladder.two_level_table_plain(q, r_dm, 300, 128)
    assert part_d.shape == (3, 2) and int(part_i[2, 0]) == 260 and int(part_i[0, 0]) == 5
    d, i = fused_ladder.two_level_min_idx(q, r_dm, 300, tile_n=128)
    assert i.tolist() == [5, 5] and d.tolist() == [0.0, 0.0]


def test_v2_expansion_exact_at_offset():
    # test_bruteforce.py:67-75: a common 1000 offset makes the expansion's
    # rounding dominate; the refine restores exactness.
    rng = np.random.default_rng(42)
    base = rng.random((2048, 3)).astype(np.float32) * 1e-3 + 1000.0
    q = rng.random((128, 3)).astype(np.float32) * 1e-3 + 1000.0
    assert_exact(_both(q, base, 2), q, base)


def test_v2_duplicate_fallback_exact():
    # test_bruteforce.py:78-85: 40 duplicates of the NN defeat the
    # certificate, so every row takes the v1 fallback and the lowest index.
    refs = np.ones((64, 4), dtype=np.float32) * 0.5
    refs[40:] = 0.9
    q = np.full((8, 4), 0.49, dtype=np.float32)
    _, cert = xla_bruteforce._expansion_idx(torch.from_numpy(q), torch.from_numpy(refs))
    assert not cert.any()
    np.testing.assert_array_equal(_both(q, refs, 2), np.zeros(8, np.int32))


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_v2_pins_full_fp32_matmul(monkeypatch, precision):
    seen = []
    real = torch.matmul

    def spy(*args, **kw):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return real(*args, **kw)

    q, r = make_dataset(16, 64, 2048, seed=3)
    monkeypatch.setattr(torch, "matmul", spy)
    torch.set_float32_matmul_precision(precision)
    try:
        got = nns_tpu_torch.nns(q, r, version=2, device="cpu")
        assert torch.get_float32_matmul_precision() == precision  # restored
    finally:
        torch.set_float32_matmul_precision("highest")
    assert seen and all(s == ("highest", False) for s in seen)
    assert_same_idx(got, np.asarray(nns_tpu.nns(q, r, version=2)), q, r)


def test_v2_delta_bound_covers_fp32_rounding():
    # The certificate's delta is the JAX package's 32 eps scale up to k = 30
    # and grows with k past it (xla_bruteforce._delta).
    scale = torch.tensor(2.0)
    for k, factor in ((3, 32.0), (16, 32.0), (30, 32.0), (64, 66.0)):
        want = np.float32(factor * xla_bruteforce._EPS) * np.float32(2.0)
        assert float(xla_bruteforce._delta(k, scale)) == pytest.approx(float(want))


@pytest.mark.parametrize("budget,expect_v4", [(1024, True), (4 << 20, False)])
def test_v6_budget_fallback(monkeypatch, budget, expect_v4):
    # test_fuzz.py:50-62: a query set over the budget takes v4, as JAX does;
    # under it, the v6 rung itself runs.
    rng = np.random.default_rng(31337)
    q = rng.random((5000, 8)).astype(np.float32)
    r = rng.random((700, 8)).astype(np.float32)
    calls = {"v4": 0, "v6": 0}
    real_v4, real_v6 = fused_ladder.nns_fused, fused_ladder.fused_queries_resident_min_idx

    def v4(*a, **kw):
        calls["v4"] += 1
        return real_v4(*a, **kw)

    def v6(*a, **kw):
        calls["v6"] += 1
        return real_v6(*a, **kw)

    monkeypatch.setattr(fused_ladder, "nns_fused", v4)
    monkeypatch.setattr(fused_ladder, "fused_queries_resident_min_idx", v6)
    idx = _both(q, r, 6, EngineConfig(vmem_query_budget_bytes=budget),
                JaxEngineConfig(vmem_query_budget_bytes=budget))
    assert calls == {"v4": int(expect_v4), "v6": int(not expect_v4)}
    assert_exact(idx, q, r)


@pytest.mark.parametrize("version", LADDER)
def test_f32_degenerate_top(version):
    # test_fuzz.py:183-200: far probes of a 1e-4-wide cluster put thousands
    # of points inside one f32 ulp of the minimum.
    rng = np.random.default_rng(9000)
    cluster = (rng.random((4096, 3)) * 1e-4).astype(np.float32)
    r = np.concatenate([cluster, np.array([[1e3, 1e3, 1e3]], np.float32)])
    q = np.concatenate([
        np.array([[300.0, 300.0, 300.0], [500.0, 0.0, 0.0]], np.float32),
        (rng.random((16, 3)) * 1e-4).astype(np.float32),
    ])
    assert_exact(_both(q, r, version), q, r)


@pytest.mark.parametrize("case_seed", range(12))
def test_fuzz_ladder_equals_jax(case_seed):
    # test_fuzz._random_case: uniform, clustered, duplicate-heavy and
    # degenerate-span refs, queries partly outside the box.
    q, r = _random_case(np.random.default_rng(1000 + case_seed))
    for version in LADDER:
        assert_exact(_both(q, r, version), q, r)


@pytest.mark.parametrize("version", LADDER)
def test_engine_build_query_many_equals_jax(version):
    q, r = make_dataset(5, 150, 3000, seed=21)
    eng = nns_tpu_torch.NNEngine(version, device="cpu").build(r)
    want = np.asarray(nns_tpu.NNEngine(version).build(r).query(q))
    got = eng.query(q)
    assert got.dtype == np.int32
    assert_same_idx(got, want, q, r)
    parts = eng.query_many([q[:40], q[40:41], q[41:]])
    assert [p.shape[0] for p in parts] == [40, 1, 109]
    np.testing.assert_array_equal(np.concatenate(parts), got)
    assert eng.query_many([]) == []
    if version == 0:
        assert eng._built is None  # the host scan stages nothing
    else:
        assert isinstance(eng._built, torch.Tensor) and eng._built.shape == r.shape


def test_engine_v3_runs_its_own_rung(monkeypatch):
    # NNEngine(3) must answer through v3's function, never a v4 engine.
    q, r = make_dataset(3, 40, 2000, seed=22)
    calls = []
    real = fused_ladder.fused_point_major_min_idx

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(fused_ladder, "fused_point_major_min_idx", spy)
    eng = nns_tpu_torch.NNEngine(3, device="cpu").build(r)
    assert not isinstance(eng._built, FusedBruteForce)
    eng.query(q)
    eng.query_many([q[:10], q[10:]])
    assert calls == [r.shape] * 3  # point-major refs, once per query call


def test_plain_twins_equal_v4_plain():
    # Each rung's plain twin gives v4's (min_d2, idx) bit for bit, the
    # property the card compares its kernels against.
    q_np, r_np = make_dataset(7, 45, 1500, seed=23)
    q, r = torch.from_numpy(q_np), torch.from_numpy(r_np)
    r_dm, tn = prepare_refs(r_np, 512, "cpu")
    want = fused_min_idx_plain(q, r_dm, 1500)
    for got in (fused_ladder.fused_point_major_min_idx(q, r),
                fused_ladder.fused_streaming_min_idx(q, r_dm, 1500),
                fused_ladder.fused_queries_resident_min_idx(q, r_dm, 1500),
                fused_ladder.two_level_min_idx(q, r_dm, 1500, tile_n=tn)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ladder_cpu_path_launches_no_kernel():
    _cuda.reset_launches()
    q, r = make_dataset(3, 20, 900, seed=24)
    for version in LADDER:
        nns_tpu_torch.nns(q, r, version=version, device="cpu")
    assert set(_cuda.LAUNCHES.values()) == {0}


def test_ladder_wrappers_reject_bad_input():
    q = torch.zeros((2, 3))
    r_dm, _ = prepare_refs(np.zeros((10, 3), np.float32), 128, "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_ladder.fused_point_major_min_idx(q, r_dm)  # not point-major (n, 3)
    with pytest.raises(ValueError, match="outside"):
        fused_ladder.fused_streaming_min_idx(q, r_dm, n=129)
    with pytest.raises(TypeError):
        fused_ladder.fused_queries_resident_min_idx(q.double(), r_dm)
    with pytest.raises(ValueError, match="tile_n"):
        fused_ladder.two_level_min_idx(q, r_dm, tile_n=0)
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ladder.two_level_min_idx(meta, torch.empty((3, 8), device="meta"))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 16, 17, 64, 300, 3000, 4096, 20000])
def test_qres_plan_covers_every_row_once(k):
    # The v6 kernel's plan (csrc/fused_queries_resident.cu): pass p writes
    # rows p * R + q * (256 // tpr) + t // tpr from the first of the tpr
    # threads of each row (q < q_rows, t < 256, R = rows_per_pass); every
    # row of m, from 1 to the 4 MB query budget, must be written exactly once,
    # and the ring's slices of dims must cover the k dimensions, within the
    # card's shared memory.
    optin = 232448  # the H100's opt-in shared memory per block
    budget_rows = (4 << 20) // (4 * k)
    for m in sorted({1, 7, 64, 255, 256, 257, 1023, 1024, 1025, 5000, budget_rows}):
        plan = fused_ladder.qres_plan(m, k, optin)
        assert plan.smem_bytes == fused_ladder.qres_smem_bytes(
            k, plan.dims, plan.tile, plan.rows_per_pass) <= optin
        assert plan.tile % 4 == 0 and 32 % plan.threads_per_row == 0
        if k in fused_ladder.QRES_TEMPLATE_KS:
            assert plan.dims == k
        else:
            assert plan.q_rows == 1 and 1 <= plan.dims <= 16
            slices = -(-k // plan.dims)
            # Sums carried over slices: 8 four-column groups per thread.
            assert slices == 1 or plan.tile <= 32 * plan.threads_per_row
            assert (slices - 1) * plan.dims < k <= slices * plan.dims
            assert slices == -(-k // 16)
        step = fused_ladder.QRES_THREADS // plan.threads_per_row
        per_pass = (np.arange(plan.q_rows)[:, None] * step + np.arange(step)).ravel()
        assert len(per_pass) == plan.rows_per_pass
        rows = (np.arange(plan.passes(m))[:, None] * plan.rows_per_pass + per_pass).ravel()
        rows = rows[rows < m]
        assert np.array_equal(np.bincount(rows, minlength=m), np.ones(m, np.int64)), m


def test_qres_plan_fits_rows_to_threads():
    optin = 232448
    plan = fused_ladder.qres_plan
    # The ladder's shapes: four rows per thread at template k, one pass of
    # 1024 rows; a run-time k one row per thread.
    assert (plan(1024, 3, optin).q_rows, plan(1024, 3, optin).threads_per_row) == (4, 1)
    assert (plan(10000, 16, optin).q_rows, plan(10000, 16, optin).passes(10000)) == (4, 10)
    assert (plan(1024, 5, optin).q_rows, plan(1024, 5, optin).threads_per_row) == (1, 1)
    # A small query set shares each row among threads instead of idling them.
    assert plan(64, 3, optin).rows_per_pass == 64
    assert plan(1, 17, optin).threads_per_row == 32
    # A large k slices the contraction instead of sharing rows, and needs the
    # same shared memory at any k: every k the 4 MB budget admits has a plan.
    assert plan(1024, 300, optin).threads_per_row == 1
    assert plan(1024, 5, optin).tile == 256 and plan(1024, 17, optin).tile == 32
    assert plan(64, 4096, optin).smem_bytes == plan(64, 1 << 20, optin).smem_bytes <= 40000
    assert (plan(1, 17, optin).dims, plan(1, 64, optin).dims, plan(1, 65, optin).dims) == (9, 16, 13)
    with pytest.raises(ValueError, match="no plan"):
        plan(1024, 5, 200)


@pytest.mark.parametrize("layout", fused_ladder.RING_LAYOUTS)
def test_ring_plan_fits_every_k(layout):
    # The v3 and v5 kernels' plans (csrc/fused_point_major.cu,
    # csrc/fused_streaming.cu) exist at every k from 1 to 20000 within the
    # H100's opt-in shared memory; v5's stays small (sliced, at most 16 dims
    # and 256 columns per stage), so it does not grow with k.
    optin = 232448
    for k in range(1, 20001):
        plan = fused_ladder.ring_plan(layout, 1024, k, optin)
        assert plan.smem_bytes == fused_ladder.ring_smem_bytes(
            layout, k, plan.cols, plan.dims, plan.stages) <= optin, k
        assert 2 <= plan.stages <= 8 and plan.cols >= 1
        assert plan.threads_per_row == 1
        if k in fused_ladder.RING_TEMPLATE_KS:
            assert plan.dims == k and plan.cols % 4 == 0 and plan.q_rows == 4
        elif layout == "dim_major":
            slices = -(-k // plan.dims)
            assert plan.q_rows == 1 and 1 <= plan.dims <= 16 and slices == -(-k // 16)
            assert (slices - 1) * plan.dims < k and plan.cols % 4 == 0
            assert slices == 1 or plan.cols <= 32  # sums carried over slices: 8 groups of 4
            assert plan.smem_bytes <= 65600
        else:
            assert plan.q_rows == (4 if k <= 8 else 1) and plan.dims == k
    with pytest.raises(ValueError, match="no plan"):
        fused_ladder.ring_plan(layout, 1024, 5, 200)


@pytest.mark.parametrize("layout", fused_ladder.RING_LAYOUTS)
def test_ring_plan_shares_rows_below_one_tile(layout):
    # Fewer than 256 rows: one tile of the fewest rows (a power of two, at
    # least 8) that holds them, the 256 consumer threads sharing each row;
    # the block folds a row's parts through its stages, which must hold 2 x
    # 256 words; v5's sliced tiles give each thread of a row at most 8
    # groups of 4 columns.
    optin = 232448
    for m, tpr in ((1, 32), (8, 32), (9, 16), (16, 16), (17, 8), (64, 4), (65, 2), (128, 2),
                   (129, 1), (255, 1)):
        for k in (*range(1, 70), 100, 300, 4096, 20000):
            plan = fused_ladder.ring_plan(layout, m, k, optin)
            assert (plan.q_rows, plan.threads_per_row, plan.q_tiles(m)) == (1, tpr, 1), (m, k)
            assert plan.smem_bytes - 16 * plan.stages >= 8 * fused_ladder.RING_CONSUMERS
            if layout == "dim_major" and plan.dims < k:
                assert plan.cols <= 4 * 8 * tpr


@pytest.mark.parametrize("k", [1, 3, 5, 16, 17, 64, 300, 4096, 20000])
@pytest.mark.parametrize("layout", fused_ladder.RING_LAYOUTS)
def test_ring_plan_covers_every_row_once(layout, k):
    # Query tile x holds rows x * R + q * S + t % S (q < q_rows, t < 256
    # consumer threads, S = 256 / threads_per_row, R = rows_per_tile), and
    # thread t scores part t // S of the columns: every row of m must be
    # scored once in each part, and written once (by part 0).
    optin = 232448
    for m in (1, 7, 16, 100, 255, 256, 257, 1000, 1023, 1024, 1025, 2000, 5000, 10000):
        plan = fused_ladder.ring_plan(layout, m, k, optin)
        tpr = plan.threads_per_row
        stride = fused_ladder.RING_CONSUMERS // tpr
        t = np.arange(fused_ladder.RING_CONSUMERS)
        per_tile = (np.arange(plan.q_rows)[:, None] * stride + t % stride).ravel()
        part = np.tile(t // stride, plan.q_rows)
        assert np.array_equal(np.bincount(per_tile * tpr + part),
                              np.ones(plan.rows_per_tile * tpr, np.int64))
        rows = (np.arange(plan.q_tiles(m))[:, None] * plan.rows_per_tile + per_tile).ravel()
        parts = np.tile(part, plan.q_tiles(m))
        keep = rows < m
        assert np.array_equal(np.bincount(rows[keep] * tpr + parts[keep], minlength=m * tpr),
                              np.ones(m * tpr, np.int64)), m
        # 4 rows per thread only where it scores no more rows than 1 would.
        assert plan.q_tiles(m) * plan.rows_per_tile <= -(-m // 256) * 256


# n * k % 4 = 3, 1, 3, 1, 0 and 0.
@pytest.mark.parametrize("k,n,splits", [(3, 5001, 7), (5, 4001, 3), (17, 2999, 5),
                                        (301, 401, 4), (16, 3001, 2), (20000, 9, 2)])
def test_point_major_stages_stop_at_n(k, n, splits):
    # A Python mirror of csrc/fused_point_major.cu's producer: stage (range,
    # t) covers points [p0, p0 + cnt) and copies the floats [p0 * k - offset,
    # (p0 + cnt) * k) with offset = p0 * k % 4, the bulk copy moving the span
    # rounded DOWN to 16 bytes from a 16-byte aligned start and the producer
    # loading the last 0-3 floats. No copy may read past n * k floats (the
    # allocation's end), every float of the refs lands in exactly one stage,
    # and the span fits the stage.
    plan = fused_ladder.ring_plan("point_major", 1024, k, 232448)
    stage_floats = layouts.round_up(plan.cols * k + 3, 4)
    cols_per_split = layouts.round_up(-(-n // splits), plan.cols)  # whole stages
    seen = np.zeros(n * k, np.int64)
    for split in range(splits):
        lo, hi = split * cols_per_split, min(n, (split + 1) * cols_per_split)
        for p0 in range(lo, hi, plan.cols):
            cnt = min(plan.cols, hi - p0)
            offset = p0 * k % 4
            start, span = p0 * k - offset, offset + cnt * k
            whole = span // 4 * 4
            assert start % 4 == 0 and start + whole <= n * k and start + span <= n * k
            assert span <= stage_floats and span - whole < 4
            if k in fused_ladder.RING_TEMPLATE_KS:
                assert offset == 0
            seen[p0 * k:(p0 + cnt) * k] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k", [64, 128])
def test_streaming_equals_jax_at_high_k(k):
    # The k at which the v5 kernel once ran out of shared memory: the port's
    # v5 (plain version on the CPU) against the JAX package's, whose Pallas
    # kernel runs in interpret mode.
    q, r = make_dataset(k, 33, 777, seed=k)
    assert_exact(_both(q, r, 5), q, r)


def test_library_signatures_match_the_c_sources():
    # Every extern "C" entry point under csrc/ is bound with one ctypes type
    # per C parameter (pointers as void*), in order: a wrong count or type
    # would pass garbage to the card without an error.
    c_types = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    found = {}
    for path in glob.glob(os.path.join(_cuda._CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r'extern "C" int (nns_\w+)\(([^)]*)\)', src):
            found[name] = [ctypes.c_void_p if "*" in p else c_types[p.rsplit(None, 1)[0]]
                           for p in (" ".join(p.split()) for p in params.split(","))]
    assert found == _cuda.SIGNATURES
