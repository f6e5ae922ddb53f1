"""Kernel tests that need the GPU: each CUDA kernel of nns_tpu_torch against
its plain PyTorch version on the card, at small shapes that reach every
code path (query tiles past m, many ref splits or tiles, ragged streamed
tiles, several passes over a ref range, rows shared by threads, several
halo tiles, padded and repeated slots, unaligned rows, exact ties).

Tolerance: indices exactly equal and min_d2 bit-equal — kernel and plain
version both round each sub, mul and add to nearest in the same order (the
kernels are built with -fmad=false), so there is nothing to tolerate.
The one exception is ``expansion_phase1`` (v9, both its kernels: wgmma, the
route at every kp, and mma.sync, the yardstick): its tensor cores sum the
bf16 products in their own order and may truncate, so its values (min1,
m2x, t2v, t3v) are held within the engine's delta of the plain version, and
its ids (tid, tid2) equal wherever the plain runner-up lies more than
2 delta away. On integer data every sum is exact, and there all six
outputs must be equal.

They skip without a CUDA device (the decision is made inside the fixture).
This file imports neither jax nor nns_tpu, so it also runs where only the
port is installed: ``python -m pytest tests/test_torch_gpu.py -q
--noconftest``.
"""

import ctypes

import numpy as np
import pytest
import torch

from nns_tpu_torch import NNEngine
from nns_tpu_torch.data import make_dataset
from nns_tpu_torch.kernels import _cuda
from nns_tpu_torch.kernels.cell_list import CellListEngine, cell_scan, cell_scan_plain
from nns_tpu_torch.kernels.fused import (
    fused_min_idx,
    fused_min_idx_plain,
    fused_splits,
    prepare_refs,
)
from nns_tpu_torch.kernels.fused_ladder import (
    QRES_TEMPLATE_KS,
    fused_point_major_min_idx,
    fused_point_major_plain,
    fused_queries_resident_min_idx,
    fused_queries_resident_plain,
    fused_streaming_min_idx,
    fused_streaming_plain,
    RING_TEMPLATE_KS,
    qres_launch_shape,
    qres_plan,
    ring_launch_shape,
    ring_plan,
    ring_splits,
    two_level_launch_shape,
    two_level_min_idx,
    two_level_plain,
    two_level_plan,
    two_level_splits,
    two_level_table_plain,
)
from nns_tpu_torch.kernels.mxu_expansion import (
    MXUExpansion,
    _cat_q,
    _phase1_cuda,
    _phase1_slots,
    device_route,
    phase1,
    phase1_plain,
    phase1_splits,
    split_bf16x3,
)
from nns_tpu_torch.kernels.oracle import recall_at_1

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


def _assert_same(kernel, plain):
    (kd, ki), (pd, pi) = kernel, plain
    torch.cuda.synchronize()
    assert torch.equal(ki, pi), f"{int((ki != pi).sum())} indices differ"
    assert torch.equal(kd, pd), "min_d2 not bit-equal"


@pytest.mark.parametrize("m,n,k", [(1, 5000, 3), (300, 5000, 3), (17, 70000, 16),
                                   (1000, 3000, 3), (40, 200_000, 3), (33, 777, 5)])
def test_fused_kernel_equals_plain(cuda, m, n, k):
    q, r = make_dataset(k, m, n, seed=100 + m)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    qd = torch.as_tensor(q, device=cuda)
    before = _cuda.LAUNCHES["fused_argmin"]
    got = fused_min_idx(qd, r_dm, n)
    assert _cuda.LAUNCHES["fused_argmin"] == before + 1
    _assert_same(got, fused_min_idx_plain(qd, r_dm, n))
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


def test_fused_kernel_splits_merge_per_query(cuda):
    # Many ref splits and several query rows whose nearest points sit in
    # different splits: the merge must read each query's own partials.
    rng = np.random.default_rng(5)
    r = rng.random((100_000, 3), dtype=np.float32)
    m = 24
    assert fused_splits(m, r.shape[0], torch.cuda.get_device_properties(cuda).multi_processor_count) > 1
    pick = np.linspace(0, r.shape[0] - 1, m).astype(np.int64)
    q = r[pick] + np.float32(1e-7)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    d, i = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, r.shape[0])
    np.testing.assert_array_equal(i.cpu().numpy(), pick)


def test_fused_kernel_duplicate_and_equal_refs(cuda):
    rng = np.random.default_rng(6)
    r = rng.random((50_000, 3), dtype=np.float32)
    target = np.array([0.25, 0.5, 0.75], np.float32)
    for w in (11, 25_000, 49_999):
        r[w] = target
    q = np.repeat(target[None], 20, 0)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    got = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, r.shape[0])
    assert (got[1].cpu().numpy() == 11).all()
    same = np.full((9000, 3), 0.5, np.float32)
    s_dm, _ = prepare_refs(same, 4096, cuda)
    qs = torch.as_tensor(rng.random((7, 3), dtype=np.float32), device=cuda)
    got = fused_min_idx(qs, s_dm, same.shape[0])
    _assert_same(got, fused_min_idx_plain(qs, s_dm, same.shape[0]))
    assert (got[1].cpu().numpy() == 0).all()


# QM = 8, 16 and 32 within one warp of the 128-thread block, 64 across its
# warps, 256 and 2048 across the 256-thread block's.
@pytest.mark.parametrize("qm,r_max", [(8, 256), (16, 2304), (2048, 1280), (32, 256),
                                      (64, 1280), (256, 2304)])
def test_cell_scan_kernel_equals_plain(cuda, qm, r_max):
    rng = np.random.default_rng(qm + r_max)
    g = 27
    halo = rng.random((g, 3, r_max), dtype=np.float32)
    halo[:, :, r_max - 100:] = 1e6  # sentinel-padded tail
    ids = rng.permutation(g * r_max).astype(np.int32).reshape(g, r_max)
    halo[3, :, 200] = halo[3, :, 7]  # an exact tie inside one group
    dense = rng.random((g, qm, 3), dtype=np.float32)
    dense[:, qm // 2:] = 0.0  # empty slots
    dense[3, 0] = halo[3, :, 7]
    args = (torch.as_tensor(dense, device=cuda), torch.as_tensor(halo, device=cuda),
            torch.as_tensor(ids, device=cuda), float(np.float32(0.05) ** 2))
    before = _cuda.LAUNCHES["cell_scan"]
    got = cell_scan(*args)
    assert _cuda.LAUNCHES["cell_scan"] == before + 1
    _assert_same(got, cell_scan_plain(*args))
    assert int(got[1][3, 0]) == min(ids[3, 7], ids[3, 200])


def _cell_case(rng, g, qm, r_max, real=0.5):
    halo = rng.random((g, 3, r_max), dtype=np.float32)
    halo[:, :, max(r_max - 50, r_max // 2):] = 1e6  # sentinel-padded tail
    ids = rng.permutation(g * r_max).astype(np.int32).reshape(g, r_max)
    dense = rng.random((g, qm, 3), dtype=np.float32)
    dense[:, int(qm * real):] = 0.0  # padded slots
    return dense, halo, ids


def _run_cell(cuda, dense, halo, ids, halo2=float(np.float32(0.05) ** 2)):
    args = (torch.as_tensor(dense, device=cuda), torch.as_tensor(halo, device=cuda),
            torch.as_tensor(ids, device=cuda), halo2)
    before = _cuda.LAUNCHES["cell_scan"]
    got = cell_scan(*args)
    assert _cuda.LAUNCHES["cell_scan"] == before + 1
    _assert_same(got, cell_scan_plain(*args))
    return got[0].cpu().numpy(), got[1].cpu().numpy()


def test_cell_scan_distinct_slot_cases(cuda):
    # Group 0 all padding, group 1 without a zero slot (and with a repeated
    # slot), group 2 a real query at the origin and one at -0.0 among the
    # padding, group 3 a halo of sentinels only: the sentinel tail wins.
    rng = np.random.default_rng(21)
    dense, halo, ids = _cell_case(rng, 6, 16, 1280)
    dense[0] = 0.0
    dense[1] = rng.random((16, 3), dtype=np.float32) + np.float32(0.01)
    dense[1, 9] = dense[1, 2]
    dense[2, 12] = 0.0
    dense[2, 13] = np.array([-0.0, 0.0, -0.0], np.float32)
    halo[3] = 1e6
    halo[2, :, 40] = 0.0  # a halo point at the origin
    d, s = _run_cell(cuda, dense, halo, ids)
    assert (d[0] == d[0, 0]).all() and (s[0] == s[0, 0]).all()
    assert d[1, 9] == d[1, 2] and s[1, 9] == s[1, 2]
    assert (s[2, 8:] == ids[2, 40]).all() and (d[2, 8:] == 0.0).all()
    assert (d[3] > 1e11).all() and (s[3] < 0).all()


def test_cell_scan_several_tiles_tie_across_tiles(cuda):
    # QM = 2048 and R_max = 8192: four ring tiles per group. An exact tie
    # between a point of the first tile and one of the fourth, the smaller
    # id in the fourth.
    rng = np.random.default_rng(22)
    dense, halo, ids = _cell_case(rng, 3, 2048, 8192, real=0.3)
    halo[1, :, 7000] = halo[1, :, 100]
    ids[1, 100], ids[1, 7000] = 5_000_000, 17
    dense[1, 0] = halo[1, :, 100]
    d, s = _run_cell(cuda, dense, halo, ids)
    assert s[1, 0] == 17 and d[1, 0] == 0.0


@pytest.mark.parametrize("r_max", [777, 1, 6])
def test_cell_scan_plain_load_path(cuda, r_max):
    # R_max not a multiple of 4: the rows are not 16-byte aligned for a bulk
    # copy, so every thread fills the stage.
    rng = np.random.default_rng(r_max)
    dense, halo, ids = _cell_case(rng, 9, 8, r_max)
    if r_max > 100:
        halo[4, :, 600] = halo[4, :, 3]
        dense[4, 0] = halo[4, :, 3]
    _run_cell(cuda, dense, halo, ids)


def test_cell_engine_cuda_equals_cpu(cuda):
    q, r = make_dataset(3, 3000, 65536, seed=7)
    batches = [q[:1000], q[1000:], (q[:400] * np.float32(0.05)).astype(np.float32)]
    gpu = CellListEngine(r, device=cuda)
    cpu = CellListEngine(r, device="cpu")
    for a, b in zip(gpu.query_queue(batches), cpu.query_queue(batches)):
        np.testing.assert_array_equal(a, b)
    idx_g, ok_g, d_g = gpu.query_with_flags_dist(q)
    idx_c, ok_c, d_c = cpu.query_with_flags_dist(q)
    np.testing.assert_array_equal(idx_g, idx_c)
    np.testing.assert_array_equal(ok_g, ok_c)
    np.testing.assert_array_equal(d_g, d_c)


# The ladder's kernels: wrapper, plain twin, and whether refs are point-major.
LADDER = {
    "fused_point_major": (fused_point_major_min_idx, fused_point_major_plain, True),
    "fused_streaming": (fused_streaming_min_idx, fused_streaming_plain, False),
    "fused_queries_resident": (fused_queries_resident_min_idx, fused_queries_resident_plain, False),
    "two_level": (two_level_min_idx, two_level_plain, False),
}


def _ladder_refs(name, r, dev):
    if LADDER[name][2]:
        return torch.as_tensor(r, device=dev)
    return prepare_refs(r, 4096, dev)[0]


# Query tiles past m, one to many ref ranges and 4096-column tables,
# streamed tiles with a ragged end, several v6 passes at k = 3 and k = 16,
# and k = 40 (the sliced v3 and v5 instances, three slices for v5).
@pytest.mark.parametrize("m,n,k", [(1, 5000, 3), (300, 5000, 3), (17, 70000, 16),
                                   (1000, 3000, 3), (40, 200_000, 3), (33, 777, 5),
                                   (6000, 2000, 3), (1100, 3000, 16), (20, 3000, 40)])
@pytest.mark.parametrize("name", sorted(LADDER))
def test_ladder_kernel_equals_plain(cuda, name, m, n, k):
    kernel, plain, _ = LADDER[name]
    q, r = make_dataset(k, m, n, seed=200 + m)
    refs = _ladder_refs(name, r, cuda)
    qd = torch.as_tensor(q, device=cuda)
    before = _cuda.LAUNCHES[name]
    got = kernel(qd, refs, n)
    assert _cuda.LAUNCHES[name] == before + 1
    _assert_same(got, plain(qd, refs, n))
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


@pytest.mark.parametrize("name", sorted(LADDER))
def test_ladder_kernel_merges_per_query(cuda, name):
    # Each query's nearest point sits in another ref range or tile, m is not
    # a multiple of the 16-row query tile: every query must read its own
    # partials.
    rng = np.random.default_rng(9)
    r = rng.random((100_000, 3), dtype=np.float32)
    pick = np.linspace(0, r.shape[0] - 1, 37).astype(np.int64)
    q = r[pick] + np.float32(1e-7)
    got = LADDER[name][0](torch.as_tensor(q, device=cuda), _ladder_refs(name, r, cuda), r.shape[0])
    np.testing.assert_array_equal(got[1].cpu().numpy(), pick)


@pytest.mark.parametrize("name", sorted(LADDER))
def test_ladder_kernel_duplicate_ties(cuda, name):
    kernel, plain, _ = LADDER[name]
    rng = np.random.default_rng(10)
    r = rng.random((50_000, 3), dtype=np.float32)
    target = np.array([0.25, 0.5, 0.75], np.float32)
    for w in (11, 4100, 25_000, 49_999):
        r[w] = target
    q = np.concatenate([np.repeat(target[None], 20, 0), rng.random((5, 3), dtype=np.float32)])
    refs = _ladder_refs(name, r, cuda)
    qd = torch.as_tensor(q, device=cuda)
    got = kernel(qd, refs, r.shape[0])
    _assert_same(got, plain(qd, refs, r.shape[0]))
    assert (got[1][:20].cpu().numpy() == 11).all()


# v6 at template k (3, 16) and run-time k (1, 5, 17, 64, 300 and, in
# slices of 16 dims, 4096 and 20000: k the 4 MB budget admits beyond the
# shared memory a whole-k stage would need), m past one pass of 256 x
# rows-per-thread rows, n not a multiple of the ring tile.
@pytest.mark.parametrize("m,n,k", [(300, 5000, 1), (1100, 70001, 3), (600, 3001, 5),
                                   (1030, 20000, 16), (257, 9999, 17), (300, 4097, 64),
                                   (40, 3000, 300), (64, 3001, 4096), (50, 1001, 20000)])
def test_queries_resident_kernel_equals_plain(cuda, m, n, k):
    q, r = make_dataset(k, m, n, seed=500 + k)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    qd = torch.as_tensor(q, device=cuda)
    plan, _ = qres_launch_shape(m, k, cuda)
    assert plan.passes(m) > 1 or plan.threads_per_row > 1
    assert plan.q_rows == 1 or k in QRES_TEMPLATE_KS
    before = _cuda.LAUNCHES["fused_queries_resident"]
    got = fused_queries_resident_min_idx(qd, r_dm, n)
    assert _cuda.LAUNCHES["fused_queries_resident"] == before + 1
    _assert_same(got, fused_queries_resident_plain(qd, r_dm, n))
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("pitch", ["padded", "unaligned"])
def test_queries_resident_ties_at_tile_edges(cuda, k, pitch):
    # Duplicates of the target on both sides of ring-tile and range edges;
    # an unaligned pitch (777 columns) takes the plain-load path.
    rng = np.random.default_rng(k)
    n = 777 if pitch == "unaligned" else 50_000
    r = rng.random((n, k), dtype=np.float32)
    target = rng.random(k, dtype=np.float32)
    cols = (255, 256, 511, 512, 776) if pitch == "unaligned" else (255, 256, 4096, 25_000, 49_999)
    for c in cols:
        r[c] = target
    q = np.concatenate([np.repeat(target[None], 300, 0), rng.random((7, k), dtype=np.float32)])
    r_dm = (torch.as_tensor(r, device=cuda).t().contiguous() if pitch == "unaligned"
            else prepare_refs(r, 4096, cuda)[0])
    qd = torch.as_tensor(q, device=cuda)
    got = fused_queries_resident_min_idx(qd, r_dm, n)
    _assert_same(got, fused_queries_resident_plain(qd, r_dm, n))
    assert (got[1][:300].cpu().numpy() == 255).all()


def test_queries_resident_plan_agrees_with_the_kernel_library(cuda):
    # qres_plan (host) and the library state one rule: the library takes
    # every plan the host makes, with the same shared memory, and refuses a
    # plan it has no instance for.
    lib = _cuda.library()
    optin = _cuda.smem_optin(lib)
    smem, slots = ctypes.c_longlong(), ctypes.c_int()
    for k in [*range(1, 81), 100, 300, 1000, 4096, 20000, 1 << 20]:
        for m in (1, 8, 64, 300, 1024, 10000):
            plan = qres_plan(m, k, optin)
            rc = lib.nns_fused_queries_resident_smem(k, plan.q_rows, plan.threads_per_row,
                                                     plan.tile, plan.dims, ctypes.byref(smem),
                                                     ctypes.byref(slots))
            assert rc == 0 and smem.value == plan.smem_bytes and slots.value >= 1, (k, m, rc)
    # (k, rows per thread, threads per row, tile, dims per stage)
    for bad in ((5, 4, 1, 32, 5), (3, 4, 2, 256, 3), (3, 1, 3, 256, 3), (3, 2, 1, 256, 3),
                (3, 1, 64, 256, 3), (3, 4, 1, 6, 3), (16, 4, 1, 256, 8), (40, 1, 1, 64, 14),
                (40, 1, 1, 32, 17), (3, 1, 1, 32, 4), (5, 1, 1, 32, 0)):
        rc = lib.nns_fused_queries_resident_smem(*bad, ctypes.byref(smem), ctypes.byref(slots))
        assert rc != 0, bad


def test_two_level_small_tiles_equal_plain(cuda):
    # 40 tiles of 128 columns, duplicates in tiles 0 and 39.
    q, r = make_dataset(3, 50, 5000, seed=11)
    r[3] = r[4990] = q[0]
    r_dm, _ = prepare_refs(r, 128, cuda)
    qd = torch.as_tensor(q, device=cuda)
    got = two_level_min_idx(qd, r_dm, 5000, tile_n=128)
    _assert_same(got, two_level_plain(qd, r_dm, 5000, tile_n=128))
    assert int(got[1][0]) == 3


# v7 on v5's ring, walked in segments cut at the table's tile boundaries:
# every k from 1 to 40 (3 and 16 the template instances, the rest sliced, 16
# dims per stage, past 16 in several slices) and 56, 300 and 1500; m past a
# query tile; 4096-column tiles and the callers' 128 and 300 (300 cuts
# stages and groups of four).
@pytest.mark.parametrize("tile_n", [128, 300, 4096])
@pytest.mark.parametrize("k", [*range(1, 41), 56, 300, 1500])
def test_two_level_kernel_equals_plain(cuda, k, tile_n):
    m, n = (300, 9001) if k <= 56 else (270, 2001)
    q, r = make_dataset(k, m, n, seed=1400 + k)
    plan, _ = two_level_launch_shape(m, k, cuda)
    assert plan.q_tiles(m) > 1
    r_dm, _ = prepare_refs(r, 4096, cuda)
    qd = torch.as_tensor(q, device=cuda)
    before = _cuda.LAUNCHES["two_level"]
    got = two_level_min_idx(qd, r_dm, n, tile_n=tile_n)
    assert _cuda.LAUNCHES["two_level"] == before + 1
    _assert_same(got, two_level_plain(qd, r_dm, n, tile_n=tile_n))
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


@pytest.mark.parametrize("m,k", [(2000, 3), (2000, 16), (2000, 5), (1030, 7), (64, 4096),
                                 (5, 3), (16, 16), (8, 6), (100, 40)])
@pytest.mark.parametrize("tile_n", [128, 300])
def test_two_level_kernel_rows_and_high_k(cuda, m, k, tile_n):
    # Two 1024-row tiles (4 rows per thread, at k = 5 the run-time-k
    # instance), several 256-row tiles, rows shared by 2-32 lanes, and
    # k = 4096 (256 slices), where the kernel before this ring needed
    # 16 k 4 bytes of shared memory and raised from k = 3633.
    n = 3001 if k == 4096 else 20_001
    q, r = make_dataset(k, m, n, seed=1500 + k + m)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    qd = torch.as_tensor(q, device=cuda)
    got = two_level_min_idx(qd, r_dm, n, tile_n=tile_n)
    _assert_same(got, two_level_plain(qd, r_dm, n, tile_n=tile_n))
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


@pytest.mark.parametrize("m", [20, 300])
@pytest.mark.parametrize("k", [3, 5, 16])
@pytest.mark.parametrize("tile_n", [128, 300])
def test_two_level_ties_at_stage_tile_and_range_edges(cuda, tile_n, k, m):
    # Duplicates of the target on both sides of a stage edge, a table-tile
    # edge and a range edge, as the launch cuts them: the lowest index must
    # win inside each tile (the table) and across tiles (the second reduce),
    # at m = 20 also across the lanes that share a row.
    rng = np.random.default_rng(60 + k + tile_n)
    n = 60_000
    plan, slots = two_level_launch_shape(m, k, cuda)
    n_tiles = -(-n // tile_n)
    per = -(-n_tiles // two_level_splits(plan, m, n_tiles, slots)) * tile_n
    assert per < n
    r = rng.random((n, k), dtype=np.float32)
    target = rng.random(k, dtype=np.float32)
    edges = sorted({plan.cols - 1, plan.cols, tile_n - 1, tile_n, per - 1, per, n - 1})
    for c in edges:
        r[c] = target
    q = np.concatenate([np.repeat(target[None], 20, 0), rng.random((m - 20, k), dtype=np.float32)])
    qd = torch.as_tensor(q, device=cuda)
    for lowest in edges[:-1]:
        r_dm, _ = prepare_refs(r, 4096, cuda)
        got = two_level_min_idx(qd, r_dm, n, tile_n=tile_n)
        table = two_level_table_plain(qd, r_dm, n, tile_n)
        _assert_same(got, two_level_plain(qd, r_dm, n, tile_n=tile_n))
        assert (got[1][:20].cpu().numpy() == lowest).all()
        assert int(table[1][lowest // tile_n, 0]) == lowest
        r[lowest] = rng.random(k, dtype=np.float32) + 2.0  # the next edge wins now


def test_two_level_plan_agrees_with_the_kernel_library(cuda):
    # two_level_plan (host) and the library state one rule: the library
    # takes every plan the host makes, with the same shared memory, and
    # refuses a plan it has no instance for.
    lib = _cuda.library()
    optin = _cuda.smem_optin(lib)
    smem, slots = ctypes.c_longlong(), ctypes.c_int()
    for k in [*range(1, 81), 100, 300, 1000, 3633, 4096, 20000]:
        for m in (1, 16, 64, 300, 1024, 10000):
            plan = two_level_plan(m, k, optin)
            rc = lib.nns_two_level_smem(k, plan.q_rows, plan.threads_per_row, plan.cols,
                                        plan.dims, plan.stages, ctypes.byref(smem),
                                        ctypes.byref(slots))
            assert rc == 0 and smem.value == plan.smem_bytes and slots.value >= 1, (k, m, rc)
    for bad in [(5, 3, 1, 256, 5, 4), (3, 4, 1, 512, 3, 1), (16, 1, 1, 0, 16, 4),
                (9, 4, 1, 256, 9, 4), (40, 1, 1, 32, 17, 4), (40, 1, 2, 128, 14, 4),
                (3, 4, 2, 512, 3, 4), (3, 1, 3, 512, 3, 4), (3, 1, 1, 4096, 3, 8)]:
        assert lib.nns_two_level_smem(*bad, ctypes.byref(smem), ctypes.byref(slots)) != 0, bad


# ---------------------------------------------------------------------------
# v3 and v5: the producer/consumer ring (ring_plan)
# ---------------------------------------------------------------------------

RING = {"point_major": "fused_point_major", "dim_major": "fused_streaming"}


def _ring_refs(layout, r, dev):
    return (torch.as_tensor(r, device=dev) if layout == "point_major"
            else prepare_refs(r, 4096, dev)[0])


def _ring_run(layout, qd, refs, n):
    name = RING[layout]
    kernel, plain, _ = LADDER[name]
    before = _cuda.LAUNCHES[name]
    got = kernel(qd, refs, n)
    assert _cuda.LAUNCHES[name] == before + 1
    _assert_same(got, plain(qd, refs, n))
    return got


@pytest.mark.parametrize("k", [56, 64, 128, 300, 1500])
def test_streaming_at_high_k(cuda, k):
    # From k = 56 a whole-k stage outgrew the opt-in shared memory and v5
    # raised; the sliced instance streams 16 dims per stage at every k
    # (1500: 94 slices).
    q, r = make_dataset(k, 300, 3001, seed=700 + k)
    plan, _ = ring_launch_shape("dim_major", 300, k, cuda)
    assert plan.dims <= 16 and plan.smem_bytes < 10_000
    got = _ring_run("dim_major", torch.as_tensor(q, device=cuda), _ring_refs("dim_major", r, cuda),
                    3001)
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


# m past one query tile and not a multiple of it: 600 rows run three
# 256-row tiles, 2000 rows two 1024-row tiles at k = 3 and 16 (4 rows per
# thread) and in v3's sliced instance at k <= 8, eight 256-row tiles past
# k = 8 in v3's and at every sliced k in v5's (1 row per thread).
@pytest.mark.parametrize("m", [600, 2000])
@pytest.mark.parametrize("k", [1, 3, 5, 16, 17, 40])
@pytest.mark.parametrize("layout", sorted(RING))
def test_ring_kernels_equal_plain(cuda, layout, k, m):
    q, r = make_dataset(k, m, 9001, seed=800 + k + m)
    plan, _ = ring_launch_shape(layout, m, k, cuda)
    assert plan.q_tiles(m) > 1 and m % plan.rows_per_tile
    sliced_rows = 4 if layout == "point_major" and k <= 8 else 1
    assert plan.q_rows == (1 if m == 600 else 4 if k in RING_TEMPLATE_KS else sliced_rows)
    assert plan.threads_per_row == 1
    got = _ring_run(layout, torch.as_tensor(q, device=cuda), _ring_refs(layout, r, cuda), 9001)
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


# n * k % 4 = 3, 3, 0, 1, 1, 3, 1; offsets 0 (aligned) to 3 floats.
@pytest.mark.parametrize("k,n,offset", [(3, 5001, 0), (3, 5001, 1), (16, 3001, 1), (5, 4001, 0),
                                        (5, 4001, 3), (17, 2999, 2), (301, 401, 1)])
def test_point_major_tail_and_offset_views(cuda, k, n, offset):
    # n * k not a multiple of 4: the last stage's bulk copy stops at the last
    # whole 16 bytes and the producer loads the rest; refs that start
    # `offset` floats into their allocation (a sliced view) take the
    # plain-load path. Nothing past row n may be read: the view ends there.
    q, r = make_dataset(k, 300, n, seed=900 + k)
    flat = torch.empty(offset + n * k, device=cuda)
    flat[offset:] = torch.as_tensor(r, device=cuda).reshape(-1)
    view = flat[offset:].view(n, k)
    assert (view.data_ptr() % 16 == 0) == (offset == 0)
    got = _ring_run("point_major", torch.as_tensor(q, device=cuda), view, n)
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


@pytest.mark.parametrize("k", [3, 5, 16, 40])
@pytest.mark.parametrize("base", ["aligned", "misaligned"])
def test_streaming_unaligned_pitch_equals_plain(cuda, k, base):
    # A 777-column pitch (not a multiple of 4 floats) and, misaligned, a base
    # 4 bytes into its allocation: the producer's plain-load path.
    q, r = make_dataset(k, 300, 777, seed=k)
    shift = 1 if base == "misaligned" else 0
    flat = torch.empty(shift + k * 777, device=cuda)
    r_dm = flat[shift:].view(k, 777)
    r_dm.copy_(torch.as_tensor(r, device=cuda).t())
    got = _ring_run("dim_major", torch.as_tensor(q, device=cuda), r_dm, 777)
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


# Fewer rows than a tile: 1 to 128 rows share each row among 32 down to 2
# threads, each scoring its own groups of columns; the block folds them.
@pytest.mark.parametrize("m,tpr", [(1, 32), (5, 32), (16, 16), (64, 4), (100, 2)])
@pytest.mark.parametrize("k", [3, 5, 16, 40])
@pytest.mark.parametrize("layout", sorted(RING))
def test_ring_kernels_share_rows_below_one_tile(cuda, layout, k, m, tpr):
    q, r = make_dataset(k, m, 20_001, seed=1100 + k + m)
    plan, slots = ring_launch_shape(layout, m, k, cuda)
    assert (plan.q_rows, plan.threads_per_row, plan.q_tiles(m)) == (1, tpr, 1)
    assert ring_splits(plan, m, 20_001, slots) > 1
    got = _ring_run(layout, torch.as_tensor(q, device=cuda), _ring_refs(layout, r, cuda), 20_001)
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


@pytest.mark.parametrize("m", [16, 300, 2000])
@pytest.mark.parametrize("k", [3, 5, 16, 40])
@pytest.mark.parametrize("layout", sorted(RING))
def test_ring_kernels_with_overflowing_distances(cuda, layout, k, m):
    # Coordinates of +-3e19: every square overflows to +inf for the even
    # rows, and for the odd rows against the first half of the refs. No
    # distance beats a start of +inf there, and the answer must still be the
    # plain version's lowest index: 0 for the even rows.
    rng = np.random.default_rng(1200 + k)
    n = 9001
    r = rng.random((n, k), dtype=np.float32)
    r[: n // 2, 0] = -3e19
    q = rng.random((m, k), dtype=np.float32)
    q[::2, 0] = 3e19
    got = _ring_run(layout, torch.as_tensor(q, device=cuda), _ring_refs(layout, r, cuda), n)
    assert torch.isinf(got[0][::2]).all() and (got[1][::2] == 0).all()
    assert torch.isfinite(got[0][1::2]).all() and (got[1][1::2] >= n // 2).all()


@pytest.mark.parametrize("m", [20, 300])
@pytest.mark.parametrize("k", [3, 5, 16])
@pytest.mark.parametrize("name", ["fused_queries_resident", "two_level"])
def test_v6_v7_with_overflowing_distances(cuda, name, k, m):
    # As above, for v6 (each pass starts at (inf, its range's first column))
    # and v7 (each table tile at (inf, the tile's first column)): the even
    # rows' every distance is +inf, and their answer must be index 0.
    rng = np.random.default_rng(1300 + k)
    n = 9001
    r = rng.random((n, k), dtype=np.float32)
    r[: n // 2, 0] = -3e19
    q = rng.random((m, k), dtype=np.float32)
    q[::2, 0] = 3e19
    kernel, plain, _ = LADDER[name]
    refs = _ladder_refs(name, r, cuda)
    qd = torch.as_tensor(q, device=cuda)
    before = _cuda.LAUNCHES[name]
    got = kernel(qd, refs, n)
    assert _cuda.LAUNCHES[name] == before + 1
    _assert_same(got, plain(qd, refs, n))
    assert torch.isinf(got[0][::2]).all() and (got[1][::2] == 0).all()
    assert torch.isfinite(got[0][1::2]).all() and (got[1][1::2] >= n // 2).all()


@pytest.mark.parametrize("m", [20, 300])
@pytest.mark.parametrize("k", [3, 5, 16])
@pytest.mark.parametrize("layout", sorted(RING))
def test_ring_ties_at_stage_and_range_edges(cuda, layout, k, m):
    # Duplicates of the target on both sides of a stage edge and of a range
    # edge, as the launch cuts them: the lowest index must win (at m = 20 also
    # across the threads that share a row).
    rng = np.random.default_rng(40 + k)
    n = 60_000
    plan, slots = ring_launch_shape(layout, m, k, cuda)
    splits = ring_splits(plan, m, n, slots)
    per_split = -(-n // splits)
    per = -(-per_split // plan.cols) * plan.cols  # whole stages per range
    assert splits > 1 and per < n
    r = rng.random((n, k), dtype=np.float32)
    target = rng.random(k, dtype=np.float32)
    edges = (plan.cols - 1, plan.cols, per - 1, per, n - 1)
    for c in edges:
        r[c] = target
    q = np.concatenate([np.repeat(target[None], 20, 0), rng.random((m - 20, k), dtype=np.float32)])
    got = _ring_run(layout, torch.as_tensor(q, device=cuda), _ring_refs(layout, r, cuda), n)
    assert (got[1][:20].cpu().numpy() == edges[0]).all()
    r[: per - 1] = rng.random((per - 1, k), dtype=np.float32) + 2.0  # now the range edge wins
    got = _ring_run(layout, torch.as_tensor(q, device=cuda), _ring_refs(layout, r, cuda), n)
    assert (got[1][:20].cpu().numpy() == per - 1).all()


@pytest.mark.parametrize("layout", sorted(RING))
def test_ring_plan_agrees_with_the_kernel_library(cuda, layout):
    # ring_plan (host) and the library state one rule: the library takes
    # every plan the host makes, with the same shared memory, and refuses a
    # plan it has no instance for.
    lib = _cuda.library()
    optin = _cuda.smem_optin(lib)
    check = getattr(lib, f"nns_{RING[layout]}_smem")
    smem, slots = ctypes.c_longlong(), ctypes.c_int()
    for k in [*range(1, 81), 100, 300, 1000, 3600, 4096, 20000]:
        for m in (1, 16, 64, 300, 1024, 10000):
            plan = ring_plan(layout, m, k, optin)
            rc = check(k, plan.q_rows, plan.threads_per_row, plan.cols, plan.dims, plan.stages,
                       ctypes.byref(smem), ctypes.byref(slots))
            assert rc == 0 and smem.value == plan.smem_bytes and slots.value >= 1, (k, m, rc)
    # (k, rows per thread, threads per row, stage columns, dims per stage,
    # stages); threads per row: a power of two up to 32, 1 with 4 rows.
    bad = [(5, 3, 1, 256, 5, 4), (3, 2, 1, 512, 3, 4), (3, 4, 1, 512, 3, 1),
           (3, 4, 1, 512, 3, 9), (16, 1, 1, 0, 16, 4), (0, 1, 1, 256, 1, 4),
           (3, 4, 2, 512, 3, 4), (3, 1, 3, 512, 3, 4), (3, 1, 64, 512, 3, 4),
           (3, 1, 0, 512, 3, 4)]
    if layout == "dim_major":
        bad += [(5, 4, 1, 256, 5, 4), (16, 4, 1, 256, 8, 4), (40, 1, 1, 64, 14, 4),
                (40, 1, 1, 32, 17, 4), (5, 1, 1, 6, 5, 4), (40, 1, 2, 128, 14, 4),
                (3, 1, 1, 4096, 3, 8)]  # the last: 393 KB of stages
    else:
        bad += [(3, 4, 1, 1022, 3, 4), (16, 1, 1, 256, 8, 4), (5, 2, 1, 256, 5, 4),
                (30000, 1, 1, 1, 30000, 2),
                (1, 1, 2, 1, 1, 2)]  # the last: stages too small for the parts' fold
    for b in bad:
        assert check(*b, ctypes.byref(smem), ctypes.byref(slots)) != 0, b


# ---------------------------------------------------------------------------
# v9 phase 1: tensor-core products, held within delta of the plain version
# ---------------------------------------------------------------------------


def _phase1_args(q, r, tile_n, ts, dev):
    eng = MXUExpansion(r, tile_n=tile_n, tile_s=ts, device=dev)
    st = eng.stage_queries(q)
    qc = _cat_q(*split_bf16x3(st.q_dev))
    return eng, st.delta, (qc, eng.rc, eng.r2h, eng.tile_n, eng.ts)


def _route(kp, ts):
    return device_route(kp, ts, "cuda")


def _counts():
    return _cuda.LAUNCHES["expansion_phase1"], _cuda.LAUNCHES["expansion_phase1_wgmma"]


def assert_phase1_close(kernel, plain, delta):
    """Values within delta (inf where plain is inf); tid equal where the
    plain runner-up m2x is more than 2 delta above min1; tid2 equal where
    the plain second tile is more than 2 delta from the first and third.
    Returns max |value difference| / delta."""
    torch.cuda.synchronize()
    k1, kt, km2, kt2v, kid2, kt3 = kernel
    p1, pt, pm2, pt2v, pid2, pt3 = plain
    worst = 0.0
    for kv, pv in ((k1, p1), (km2, pm2), (kt2v, pt2v), (kt3, pt3)):
        fin = torch.isfinite(pv)
        assert torch.equal(torch.isfinite(kv), fin)
        if fin.any():
            worst = max(worst, float((kv[fin].double() - pv[fin].double()).abs().max()) / delta)
    assert worst <= 1.0, f"values differ by {worst} delta"
    sep = (pm2 - p1) > 2 * delta
    assert torch.equal(kt[sep], pt[sep]), f"{int((kt[sep] != pt[sep]).sum())} tid differ"
    sep2 = ((pt2v - p1) > 2 * delta) & ((pt3 - pt2v) > 2 * delta)
    assert torch.equal(kid2[sep2], pid2[sep2]), "tid2 differ"
    return worst


@pytest.mark.parametrize("m,n,k,tile_n,ts", [(33, 777, 10, 128, 128), (300, 5000, 16, 512, 256),
                                             (1000, 70000, 16, 4096, 256),
                                             (17, 3000, 24, 640, 640), (129, 20000, 8, 1024, 256),
                                             (1, 300, 16, 128, 64), (200, 9000, 88, 1024, 256),
                                             (300, 9000, 96, 1024, 256),
                                             (301, 9000, 96, 1024, 64),
                                             (130, 5000, 128, 512, 128),
                                             (64, 3000, 200, 1024, 256),
                                             (100, 9000, 40, 1024, 256)])
def test_phase1_kernel_within_delta_of_plain(cuda, m, n, k, tile_n, ts):
    q, r = make_dataset(k, m, n, seed=300 + m)
    eng, delta, args = _phase1_args(q, r, tile_n, ts, cuda)
    before = _cuda.LAUNCHES["expansion_phase1"]
    got = phase1(*args, rc_t=eng.rc_t)
    assert _cuda.LAUNCHES["expansion_phase1"] == before + 1
    assert_phase1_close(got, phase1_plain(*args), delta)


@pytest.mark.parametrize("m,n,k,tile_n,ts", [(1, 300, 16, 128, 64), (33, 777, 16, 128, 128),
                                             (1000, 70000, 16, 4096, 256),
                                             (300, 9000, 32, 1024, 256),
                                             (129, 20000, 48, 1024, 256),
                                             (129, 20000, 8, 1024, 256),
                                             (300, 9000, 24, 1024, 256),
                                             (33, 777, 24, 128, 64),
                                             (200, 9000, 40, 1024, 128),
                                             (200, 9000, 88, 1024, 256),
                                             (130, 9000, 96, 1024, 256),
                                             (300, 9000, 128, 1024, 256),
                                             (129, 5000, 128, 512, 64),
                                             (64, 3000, 200, 1024, 256),
                                             (64, 3000, 200, 1024, 64)])
def test_phase1_wgmma_kernel_within_delta_of_plain(cuda, m, n, k, tile_n, ts):
    # Every kp: 16-aligned with the query tile resident, 8 more than a
    # multiple of 16 (8, 24, 40, 88: each block padded with zero dims), and
    # past a resident tile (128, 200: dimension slices of up to 48).
    q, r = make_dataset(k, m, n, seed=400 + m + k)
    eng, delta, args = _phase1_args(q, r, tile_n, ts, cuda)
    assert _route(eng.kp, ts) == "wgmma"
    before = _counts()
    got = phase1(*args, rc_t=eng.rc_t)
    assert _counts() == (before[0] + 1, before[1] + 1)
    assert_phase1_close(got, phase1_plain(*args), delta)


def test_phase1_mma_sync_kernel_where_kp_is_not_16_aligned(cuda):
    # k = 24: kp = 24 now takes the wgmma kernel (blocks padded to 32 dims);
    # the mma.sync kernel, no route any more, still answers through its own
    # entry point (the yardstick), and both stay within delta of the plain
    # version. The engine keeps rc_t alone.
    q, r = make_dataset(24, 200, 9000, seed=24)
    eng, delta, args = _phase1_args(q, r, 1024, 256, cuda)
    assert _route(eng.kp, eng.ts) == "wgmma" and eng.rc_t is not None
    before = _counts()
    got = phase1(*args, rc_t=eng.rc_t)
    assert _counts() == (before[0] + 1, before[1] + 1)
    assert_phase1_close(got, phase1_plain(*args), delta)
    yard = _phase1_cuda(args[0], eng.rc.contiguous(), *args[2:], None, "mma_sync")
    assert _counts() == (before[0] + 2, before[1] + 1)
    assert_phase1_close(yard, phase1_plain(*args), delta)


def test_phase1_mma_sync_kernel_at_kp16(cuda):
    # The mma.sync kernel through its own entry point at the main path's kp:
    # chip_smoke.py's yardstick, held to the same tolerance. The engine keeps
    # only rc_t there, so rc is made contiguous for it.
    q, r = make_dataset(16, 300, 20000, seed=16)
    eng, delta, args = _phase1_args(q, r, 1024, 256, cuda)
    assert not eng.rc.is_contiguous()
    before = _counts()
    got = _phase1_cuda(args[0], eng.rc.contiguous(), *args[2:], None, "mma_sync")
    assert _counts() == (before[0] + 1, before[1])
    assert_phase1_close(got, phase1_plain(*args), delta)


def test_phase1_wgmma_route_needs_rc_t(cuda):
    # The wgmma route reads the engine's rc_t; without it phase1 raises
    # instead of transposing rc on every call.
    q, r = make_dataset(16, 20, 3000, seed=5)
    _, _, args = _phase1_args(q, r, 1024, 256, cuda)
    before = _counts()
    with pytest.raises(ValueError, match="rc_t"):
        phase1(*args)
    assert _counts() == before


@pytest.mark.parametrize("ts", [64, 128, 192, 256, 320, 640])
def test_phase1_route_agrees_with_the_kernel_library(cuda, ts):
    # phase1_route (host) and wgmma_setup (csrc/expansion_phase1.cu) state
    # the same rule: every shape the host sends to the wgmma kernel, the
    # library takes, and it refuses every other.
    lib = _cuda.library()
    for kp in range(8, 265, 8):
        blocks = ctypes.c_int()
        rc = lib.nns_expansion_phase1_wgmma_blocks_per_sm(kp, ts, ctypes.byref(blocks))
        assert (rc == 0) == (_route(kp, ts) == "wgmma"), (kp, ts, rc)
        assert rc != 0 or blocks.value >= 1
    # Every kp the engine makes has a plan; none where kp % 8 != 0 or
    # ts % 64 != 0, and the route says so.
    assert all(_route(kp, ts) == "wgmma" for kp in range(8, 265, 8))
    for kp, bad_ts in ((12, ts), (16, ts + 32)):
        rc = lib.nns_expansion_phase1_wgmma_blocks_per_sm(kp, bad_ts, ctypes.byref(blocks))
        assert rc != 0 and _route(kp, bad_ts) == "none", (kp, bad_ts)


@pytest.mark.parametrize("m,tile_n,ts,k", [(40, 512, 128, 16), (300, 256, 64, 16),
                                            (7, 4096, 256, 16), (64, 512, 128, 100),
                                            (40, 512, 128, 24), (64, 512, 64, 200)])
def test_phase1_kernel_merges_ranges_per_query(cuda, m, tile_n, ts, k):
    # Integer coordinates make every sum exact in any order, so all six
    # outputs must equal the plain version's. Exact duplicates of each
    # query's nearest point sit in other ref ranges, and two whole tiles
    # are identical: every merge rule meets a tie. The wgmma kernel runs
    # with its query tile resident at k = 16 and 24 (padded to 32 dims), and
    # in dimension slices of 48 at k = 100 (kp = 104: 48, 48, 16 with 8 of
    # padding) and k = 200.
    rng = np.random.default_rng(m + tile_n)
    n = 200_000
    r = rng.integers(0, 4, (n, k)).astype(np.float32)
    q = rng.integers(0, 4, (m, k)).astype(np.float32)
    near = np.array([int(np.argmin(((r - qi) ** 2).sum(1))) for qi in q])
    for i, w in enumerate(near):
        for dup in (w + 61_000, w + 127_000, w * 7 + 13):
            r[dup % n] = r[w]
    r[tile_n:2 * tile_n] = r[:tile_n]
    kp = -(-k // 8) * 8
    route = _route(kp, ts)
    assert route == "wgmma"
    slots = _phase1_slots(_cuda.library(), kp, cuda, route, ts)
    assert phase1_splits(m, -(-n // tile_n), slots) > 1
    eng, _, args = _phase1_args(q, r, tile_n, ts, cuda)
    before = _counts()
    got, want = phase1(*args, rc_t=eng.rc_t), phase1_plain(*args)
    assert _counts() == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("g_rel", [0.0, 1e-7, 1e-6, 1e-5, 1e-3, 1e-1])
def test_v9_near_ties_on_card(cuda, g_rel):
    # Runner-up gaps around the band: a certified row is never wrong, and
    # the engine's answer is exact and equals the CPU engine's.
    rng = np.random.default_rng(12)
    k = 16
    refs = rng.random((50_000, k)).astype(np.float32) + 2.0
    q = np.zeros((4, k), dtype=np.float32)
    q[1:] = rng.random((3, k), dtype=np.float32)
    refs[7] = 0.0
    refs[7, 0] = 1.0
    refs[31_313] = 0.0
    refs[31_313, 0] = np.float32(np.sqrt(1.0 + 2.0 * g_rel))
    eng = MXUExpansion(refs, device=cuda)
    _, idx, cert = eng.query_min_idx_cert(q)
    d = ((q[:, None, :].astype(np.float64) - refs[None]) ** 2).sum(-1)
    dmin = d.min(1)
    assert (d[np.arange(4), idx][cert] == dmin[cert]).all(), "certified a wrong row"
    out = eng.query(q)
    assert (d[np.arange(4), out] == dmin).all()
    np.testing.assert_array_equal(out, MXUExpansion(refs, device="cpu").query(q))


def test_v9_engine_equals_v4_kernel(cuda):
    q, r = make_dataset(16, 3000, 100_000, seed=13)
    got = MXUExpansion(r, device=cuda).query(q)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    _, want = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, r.shape[0])
    np.testing.assert_array_equal(got, want.cpu().numpy())


def test_v9_engine_at_kp96_with_64_column_subtiles(cuda):
    # kp = 96: the wgmma kernel keeps its query tile resident beside a ring
    # of 64-column chunks (221,696 bytes of shared memory).
    q, r = make_dataset(96, 300, 20_000, seed=96)
    eng = MXUExpansion(r, tile_s=64, device=cuda)
    assert (eng.kp, eng.ts, eng.route) == (96, 64, "wgmma") and eng._rc is None
    before = _counts()
    got = eng.query(q)
    assert _counts() == (before[0] + 1, before[1] + 1)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    _, want = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, r.shape[0])
    np.testing.assert_array_equal(got, want.cpu().numpy())


@pytest.mark.parametrize("k", [24, 96, 128])
def test_auto_engine_at_high_k_on_card(cuda, k):
    # NNEngine("auto") picks v9 for k >= 8, and phase 1 runs on the wgmma
    # kernel at every kp: padded blocks at k = 24, the query tile resident
    # at 96, dimension slices at 128.
    q, r = make_dataset(k, 500, 20_000, seed=k)
    eng = NNEngine(device="cuda").build(r)
    assert eng.spec.num == 9 and isinstance(eng._built, MXUExpansion)
    before = _counts()
    got = eng.query(q)
    assert _counts() == (before[0] + 1, before[1] + 1)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    _, want = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, r.shape[0])
    np.testing.assert_array_equal(got, want.cpu().numpy())
    assert recall_at_1(got, q, r) == 1.0
