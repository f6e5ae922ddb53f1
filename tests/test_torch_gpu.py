"""Kernel tests that need the GPU: each CUDA kernel of nns_tpu_torch against
its plain PyTorch version on the card, at small shapes that reach every
code path (query tiles past m, many ref splits or tiles, ragged streamed
tiles, several passes over a ref range, rows shared by threads, several
halo tiles, padded and repeated slots, unaligned rows, exact ties).

Tolerance: indices exactly equal and min_d2 bit-equal — kernel and plain
version both round each sub, mul and add to nearest in the same order (the
kernels are built with -fmad=false), so there is nothing to tolerate.
The one exception is ``expansion_phase1`` (v9, the wgmma kernels at every
kp): its tensor cores sum the bf16 products in their own order and may truncate, so its values (min1,
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
    _FOLD_STATE,
    _tensor_map,
    fused_launch_shape,
    fused_min_idx,
    fused_min_idx_plain,
    fused_plan,
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
    _phase1_slots,
    phase1,
    phase1_plain,
    phase1_plan,
    phase1_splits,
    split_bf16x3,
)
from nns_tpu_torch.kernels.layouts import pow2_at_least
from nns_tpu_torch.kernels.oracle import recall_at_1
from sentinel_corner import corner_rows

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
    assert fused_launch_shape(m, 3, r.shape[0], torch.cuda.current_device())[1] > 1
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


def _v4(q, r_dm, n):
    """The v4 kernel on card tensors: one launch counted, and bit-equal to
    the plain version."""
    before = _cuda.LAUNCHES["fused_argmin"]
    got = fused_min_idx(q, r_dm, n)
    assert _cuda.LAUNCHES["fused_argmin"] == before + 1
    _assert_same(got, fused_min_idx_plain(q, r_dm, n))
    return got


def _v4_shape(m, k, n):
    return fused_launch_shape(m, k, n, torch.cuda.current_device())


# Every kind of plan: 1-64 rows shared by 32 down to 4 threads each, 300
# rows one per thread in two 256-row tiles, 2000 rows in two 1024-row tiles
# at k = 3 and 16 (4 rows per thread) and eight 256-row tiles at a sliced k;
# k = 5, 40 and 128 in the sliced instance (one, three and eight slices).
@pytest.mark.parametrize("m", [1, 8, 16, 64, 300, 2000])
@pytest.mark.parametrize("k", [3, 5, 16, 40, 128])
def test_v4_kernel_equals_plain(cuda, m, k):
    n = 20_001
    q, r = make_dataset(k, m, n, seed=1400 + k + m)
    plan, splits = _v4_shape(m, k, n)
    assert splits > 1 and plan.cols <= 256
    got = _v4(torch.as_tensor(q, device=cuda), prepare_refs(r, 4096, cuda)[0], n)
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


def test_v4_kernel_at_k4096(cuda):
    # The first v4 kernel staged 16 x k x 4 bytes of queries per block and raised
    # from k = 3633 (past the 232,448-byte opt-in); the sliced instance
    # streams 16 dims per stage, so its shared memory does not grow with k.
    q, r = make_dataset(4096, 64, 3001, seed=1500)
    plan, _ = _v4_shape(64, 4096, 3001)
    assert plan.dims == 16 and plan.smem_bytes < 40_000
    got = _v4(torch.as_tensor(q, device=cuda), prepare_refs(r, 4096, cuda)[0], 3001)
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


@pytest.mark.parametrize("m", [20, 300, 1100])
@pytest.mark.parametrize("k", [3, 5, 16])
def test_v4_ties_at_stage_range_and_tile_edges(cuda, k, m):
    # Duplicates of the target on both sides of a stage edge and of a range
    # edge, asked by rows on both sides of a query-tile edge: the lowest
    # index must win, whichever block folds the tile last.
    rng = np.random.default_rng(1600 + k + m)
    n = 60_000
    plan, splits = _v4_shape(m, k, n)
    per = -(-(-(-n // splits)) // plan.cols) * plan.cols  # whole stages per range
    assert splits > 1 and per < n
    r = rng.random((n, k), dtype=np.float32)
    target = rng.random(k, dtype=np.float32)
    edges = (plan.cols - 1, plan.cols, per - 1, per, n - 1)
    for c in edges:
        r[c] = target
    q = rng.random((m, k), dtype=np.float32)
    tile = plan.rows_per_tile
    rows = sorted({0, m - 1, *(x for x in (tile - 1, tile) if x < m)})
    assert m < tile or len(rows) == 4
    q[rows] = target
    qd = torch.as_tensor(q, device=cuda)
    got = _v4(qd, prepare_refs(r, 4096, cuda)[0], n)
    assert (got[1][rows].cpu().numpy() == edges[0]).all()
    r[: per - 1] = rng.random((per - 1, k), dtype=np.float32) + 2.0  # now the range edge wins
    got = _v4(qd, prepare_refs(r, 4096, cuda)[0], n)
    assert (got[1][rows].cpu().numpy() == per - 1).all()


@pytest.mark.parametrize("m", [8, 300, 2000])
@pytest.mark.parametrize("k", [3, 5, 16])
def test_v4_with_overflowing_distances(cuda, k, m):
    # Coordinates of +-3e19: every distance of the even rows overflows to
    # +inf, so nothing beats a start of (inf, the range's first column) and
    # the answer must be index 0, as the plain version gives.
    rng = np.random.default_rng(1700 + k)
    n = 9001
    r = rng.random((n, k), dtype=np.float32)
    r[: n // 2, 0] = -3e19
    q = rng.random((m, k), dtype=np.float32)
    q[::2, 0] = 3e19
    got = _v4(torch.as_tensor(q, device=cuda), prepare_refs(r, 4096, cuda)[0], n)
    assert torch.isinf(got[0][::2]).all() and (got[1][::2] == 0).all()
    assert torch.isfinite(got[0][1::2]).all() and (got[1][1::2] >= n // 2).all()


# Pitch 777 (not a multiple of 4 floats) on any base, and pitch 780 on a
# base 4 bytes into its allocation: no tensor map, the producer lanes load
# each stage. Pitch 780 at 0 or 16 bytes in: the tensor-copy path, the
# second with an offset base.
@pytest.mark.parametrize("pitch,shift", [(777, 0), (777, 1), (780, 1), (780, 0), (780, 4)])
@pytest.mark.parametrize("k", [3, 5, 16, 40])
def test_v4_pitch_and_offset_views(cuda, k, pitch, shift):
    q, r = make_dataset(k, 300, 777, seed=1800 + k)
    flat = torch.empty(shift + k * pitch, device=cuda)
    r_dm = flat[shift:].view(k, pitch)
    r_dm[:, :777] = torch.as_tensor(r, device=cuda).t()
    r_dm[:, 777:] = -1.0  # past n: never read as a column
    assert (r_dm.data_ptr() % 16 == 0) == (shift in (0, 4))
    got = _v4(torch.as_tensor(q, device=cuda), r_dm, 777)
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


def test_v4_tensor_map_refuses_what_it_cannot_describe(cuda):
    flat = torch.empty(4 + 3 * 780, device=cuda)
    base = flat.data_ptr()
    assert _tensor_map(base, 3, 780, 780, 256, 3)  # aligned: encoded
    for ptr, ld, cols, dims in ((base + 4, 780, 256, 3), (base, 777, 256, 3),
                                (base, 780, 512, 3), (base, 780, 6, 3), (base, 780, 256, 0)):
        with pytest.raises(RuntimeError):
            _tensor_map(ptr, 3, min(ld, 777), ld, cols, dims)


def test_v4_back_to_back_launches_reset_the_fold(cuda):
    # Launches on one stream share the fold's keys and tickets, and each
    # must leave them as it found them: shapes with different ranges S and
    # query tiles in turn, with no synchronization between them.
    cases = [(2000, 3, 20_001), (8, 3, 100_000), (300, 16, 9001), (2000, 3, 20_001),
             (64, 5, 50_000), (8, 3, 100_000)]
    assert len({_v4_shape(m, k, n)[1] for m, k, n in cases}) >= 3
    inputs, outs = [], []
    for i, (m, k, n) in enumerate(cases):
        q, r = make_dataset(k, m, n, seed=1900 + i)
        qd, r_dm = torch.as_tensor(q, device=cuda), prepare_refs(r, 4096, cuda)[0]
        inputs.append((qd, r_dm, n))
        outs.append(fused_min_idx(qd, r_dm, n))
    torch.cuda.synchronize()
    for (qd, r_dm, n), got in zip(inputs, outs):
        _assert_same(got, fused_min_idx_plain(qd, r_dm, n))
    keys, tickets = _FOLD_STATE[(torch.cuda.current_device(),
                                 torch.cuda.current_stream().cuda_stream)]
    assert (keys == -1).all() and (tickets == 0).all()


def test_v4_plan_agrees_with_the_kernel_library(cuda):
    # fused_plan (host) and the library state one rule: the library takes
    # every plan the host makes, with the same shared memory, and refuses a
    # plan it has no instance for.
    lib = _cuda.library()
    optin = _cuda.smem_optin(lib)
    smem, slots = ctypes.c_longlong(), ctypes.c_int()
    for k in [*range(1, 81), 100, 300, 1000, 3600, 4096, 20000]:
        for m in (1, 8, 16, 64, 300, 1024, 10000):
            plan = fused_plan(m, k, optin)
            rc = lib.nns_fused_argmin_smem(k, plan.q_rows, plan.threads_per_row, plan.cols,
                                           plan.dims, plan.stages, ctypes.byref(smem),
                                           ctypes.byref(slots))
            assert rc == 0 and smem.value == plan.smem_bytes and slots.value >= 1, (k, m, rc)
    # (k, rows per thread, threads per row, stage columns, dims per stage,
    # stages): a stage past one box, stages not a multiple of 128 bytes, too
    # few or many stages, rows a sliced instance cannot hold, bad sharing.
    bad = [(3, 4, 1, 512, 3, 4), (3, 4, 1, 260, 3, 4), (5, 1, 1, 20, 5, 4),
           (3, 4, 1, 256, 3, 1), (3, 4, 1, 256, 3, 9), (5, 4, 1, 256, 5, 4),
           (40, 1, 1, 64, 14, 4), (40, 1, 1, 32, 17, 4), (0, 1, 1, 256, 1, 4),
           (3, 4, 2, 256, 3, 4), (3, 1, 3, 256, 3, 4), (3, 1, 64, 256, 3, 4)]
    for args in bad:
        assert lib.nns_fused_argmin_smem(*args, ctypes.byref(smem), ctypes.byref(slots)) != 0, args


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


@pytest.mark.parametrize("n_shards", [None, 4])
def test_device_staging_equals_host_staging(cuda, n_shards):
    # query_staged (upload, scatter, scan and gather on the card) against the
    # host-staged path (dense scatter in numpy, the scan, the gather at the
    # flat slots), on one device and on Mesh.virtual(4): signed winners and
    # d2 bit-equal, on a uniform, a skewed (QM >= 512) and an out-of-box
    # batch; one launch per batch, or per shard that holds rows.
    from nns_tpu_torch.parallel import Mesh, ShardedCellEngine

    q, r = make_dataset(3, 3000, 65536, seed=9)
    skew = q.copy()
    skew[:600] = np.float32(0.51) + q[:600] * np.float32(0.01)
    ood = (q * np.float32(2.0) - np.float32(0.5)).astype(np.float32)
    single = CellListEngine(r, device=cuda)
    eng = single if n_shards is None else ShardedCellEngine(r, Mesh.virtual(n_shards, "cuda"))
    for b in (q, skew, ood):
        packed, _, q_max = single.stage(b)
        dense, fslots = single._dense_scatter(packed, q_max)
        dmin, sgid = cell_scan(torch.as_tensor(dense, device=cuda), single.halo_dm,
                               single.halo_ids_dev, single.halo2)
        slots = torch.as_tensor(fslots.astype(np.int64), device=cuda)
        _cuda.reset_launches()
        signed, d2 = eng.query_staged(packed, q_max)
        torch.cuda.synchronize()
        want_launches = 1 if n_shards is None else int(
            (np.diff(eng._shard_cuts(packed)) > 0).sum())
        assert _cuda.LAUNCHES["cell_scan"] == want_launches
        assert signed.device == slots.device and torch.equal(signed, sgid.reshape(-1)[slots])
        if n_shards is None:
            assert torch.equal(d2.view(torch.int32), dmin.reshape(-1)[slots].view(torch.int32))
        else:
            assert d2 is None
    assert single.stage(skew)[2] >= 512


def _bin_queue_case(case, eng, rng):
    """A queue for the binning kernels: uniform batches, rows on supercell
    faces (and one f32 ulp off them), rows outside the box, a batch above
    the 2048 skew limit, an empty batch; "large" has one batch past the
    kernels' 1024 blocks of 256 rows, "many" more batches than a grid has
    rows (65535); "nonfinite" is "mixed" with NaN and +-inf coordinates in
    the first and last rows of batches and in every 97th row of the last
    one (many warps each see one)."""
    if case == "large":
        return [rng.random((300_000, 3), dtype=np.float32), rng.random((7, 3), dtype=np.float32)]
    if case == "many":
        return [rng.random((int(k), 3), dtype=np.float32) for k in rng.integers(0, 3, 70_000)]
    j = rng.integers(0, eng.D + 1, (500, 3))
    faces = (eng.mn + j * eng.W).astype(np.float32)
    faces[::3] = np.nextafter(faces[::3], np.float32(np.inf))
    faces[1::3] = np.nextafter(faces[1::3], np.float32(-np.inf))
    outside = (rng.random((200, 3), dtype=np.float32) * np.float32(3.0)
               - np.float32(1.0)).astype(np.float32)
    skewed = (np.float32(0.5) + rng.random((2 * eng.q_max_limit() + 10, 3), dtype=np.float32)
              * np.float32(1e-4)).astype(np.float32)
    queue = [rng.random((1000, 3), dtype=np.float32), faces, outside, skewed,
             np.zeros((0, 3), np.float32), rng.random((3000, 3), dtype=np.float32)]
    if case == "nonfinite":
        queue[0][0, 0] = np.nan
        queue[1][-1, 1] = np.inf
        queue[2][0, 2] = -np.inf
        queue[5][::97, 1] = np.nan
        queue[5][-1] = (np.inf, np.nan, -np.inf)
    return queue


@pytest.mark.parametrize("case", ["mixed", "large", "many", "nonfinite"])
def test_cell_bin_kernels_equal_twin(cuda, case):
    # bin_queue's kernel against its plain twin: sids, per-supercell counts,
    # per-batch maxima and the count of rows with a NaN or an infinity
    # bit-equal (that count is 0 on a finite queue); each (batch,
    # supercell)'s slots are 0..count-1 in both, in any order. place_queue's
    # kernel on the same
    # plan: each row sits at its slot, every slot lies in the row's
    # (batch, supercell) block as the twin's does, every other slot is
    # zero, and a batch without a table points its rows past the last slot.
    from nns_tpu_torch.kernels.cell_list import (_upload_queue, bin_queue, bin_queue_plain,
                                                 place_queue, place_queue_plain)

    _, r = make_dataset(3, 1, 4096 if case == "many" else 65536, seed=21)
    eng = CellListEngine(r, device=cuda)
    queue = _bin_queue_case(case, eng, np.random.default_rng(22))
    sizes = [len(b) for b in queue]
    rows, offs = _upload_queue(queue, cuda)
    rows_c, offs_c = rows.cpu(), offs.cpu()
    assert torch.equal(rows_c.view(torch.int32),
                       torch.from_numpy(np.concatenate(queue)).view(torch.int32))
    _cuda.reset_launches()
    got = [t.cpu() for t in bin_queue(rows, offs, max(sizes), eng.D, eng.mn, eng.W)]
    assert _cuda.LAUNCHES["cell_bin"] == 1
    want = bin_queue_plain(rows_c, offs_c, eng.D, eng.mn, eng.W)
    for name, a, b in zip(("sid", "pos", "counts", "maxima"), got, want, strict=True):
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape, name
        if name != "pos":
            assert torch.equal(a, b), f"{name}: {int((a != b).sum())} differ"
    sid, pos, _, maxima = got
    assert int(maxima[-1]) == sum(int((~np.isfinite(b)).any(1).sum()) for b in queue)
    assert int(maxima[-1]) == (3 + 31 + 1 if case == "nonfinite" else 0)
    maxima = maxima[:-1]
    batch = torch.repeat_interleave(torch.arange(len(queue)), torch.tensor(sizes))
    key = (batch * eng.D ** 3 + sid.long()) * (int(maxima.max()) + 1)
    assert torch.equal(torch.sort(key + pos.long())[0], torch.sort(key + want[1].long())[0])

    q_max = np.array([pow2_at_least(max(x, 8)) if m else 0
                      for m, x in zip(sizes, maxima.tolist())], dtype=np.int64)
    q_max[q_max > eng.q_max_limit()] = 0
    plan = np.zeros((len(queue), 2), np.int64)
    plan[:, 1] = q_max
    np.cumsum(eng.D ** 3 * q_max[:-1], out=plan[1:, 0])
    slots = int(plan[-1, 0] + eng.D ** 3 * q_max[-1])
    slot = torch.empty(len(batch), dtype=torch.int64, device=cuda)
    table = place_queue(rows, offs, max(sizes), got[0].to(cuda), got[1].to(cuda),
                        torch.from_numpy(plan).to(cuda), slots, slot).cpu()
    assert _cuda.LAUNCHES["cell_place"] == 1
    slot = slot.cpu()
    t_slot = torch.empty(len(batch), dtype=torch.int64)
    t_table = place_queue_plain(rows_c, offs_c, want[0], want[1], torch.from_numpy(plan), slots,
                                t_slot)
    placed = slot < slots
    assert torch.equal(placed, t_slot < slots)
    assert torch.equal(placed, torch.from_numpy(q_max)[batch] > 0)
    assert torch.equal(slot[placed] - pos[placed], t_slot[placed] - want[1][placed])
    assert torch.equal(table[slot[placed]].view(torch.int32), rows_c[placed].view(torch.int32))
    assert len(torch.unique(slot[placed])) == int(placed.sum())
    table[slot[placed]] = 0.0
    t_table[t_slot[placed]] = 0.0
    assert not table.any() and not t_table.any()
    if case == "mixed":
        assert (q_max > 0).tolist() == [True, True, True, False, False, True]
    # The same plan cut into two runs of batches, as the drain's parts are:
    # each run's table equals its stretch of the whole table, and each run
    # writes its rows' slots, counted from the run's first slot, in place.
    cut = len(queue) // 2
    start = int(plan[cut, 0])
    runs = plan.copy()
    runs[cut:, 0] -= start
    runs_dev = torch.from_numpy(runs).to(cuda)
    slot2 = torch.full((len(batch),), -1, dtype=torch.int64, device=cuda)
    sid_d, pos_d = got[0].to(cuda), got[1].to(cuda)
    whole = place_queue(rows, offs, max(sizes), sid_d, pos_d, torch.from_numpy(plan).to(cuda),
                        slots, torch.empty_like(slot2)).cpu()
    for a, b, first, n in ((0, cut, 0, start), (cut, len(queue), start, slots - start)):
        part = place_queue(rows, offs[a:b + 1], max(sizes), sid_d, pos_d, runs_dev[a:b], n,
                           slot2)
        assert torch.equal(part.cpu().view(torch.int32), whole[first:first + n].view(torch.int32))
        lo, hi = sum(sizes[:a]), sum(sizes[:b])
        want_slot = torch.where(slot[lo:hi] < slots, slot[lo:hi] - first, n)
        assert torch.equal(slot2.cpu()[lo:hi], want_slot)


def test_device_binned_drain_equals_host_staged_drain(cuda):
    # query_queue bins and answers on the card; the sharded engine keeps the
    # host-staged drain (stage, query_staged per pack) and the host tail.
    # On one virtual shard of the card both answer the same queues: each
    # row's idx before the exact re-answer, each batch's certified rows and
    # the set of uncertified rows (the answer kernel's, against the flags
    # the host tail hands _exact_rows), the answers and the coverage
    # bit-equal. One bin, one place and one answer launch, one scan per
    # batch that is neither skewed nor empty, one exact call for a queue
    # with uncertified rows;
    # the staged-rows counter counts the rows of the batches not skewed.
    # The sharded drain, the reference, neither bins nor answers on the
    # card and counts no device-staged rows.
    from nns_tpu_torch.parallel import Mesh, ShardedCellEngine
    from nns_tpu_torch.utils.spans import COUNTS

    _, r = make_dataset(3, 1, 1 << 20, seed=23)
    single = CellListEngine(r, device=cuda)
    host = ShardedCellEngine(r, Mesh.virtual(1, "cuda"))
    rng = np.random.default_rng(23)
    corner = rng.random((1200, 3), dtype=np.float32)
    corner[:600] = np.float32(0.3) + corner[:600] * np.float32(0.004)  # QM 1024
    queues = [[rng.random((10_000, 3), dtype=np.float32) for _ in range(8)],
              _bin_queue_case("mixed", single, rng) + [corner],
              [(rng.random((10_000, 3), dtype=np.float32) * np.float32(2.0)
                - np.float32(0.5)).astype(np.float32)]]
    for queue in queues:
        seen = []
        exact = host._exact_rows
        host._exact_rows = lambda qb, idx, ok: seen.append((idx.copy(), ok.copy())) or exact(
            qb, idx, ok)
        _cuda.reset_launches()
        before = COUNTS["cells.device_staged_rows"]
        want, cov_h = host.query_queue(queue, return_coverage=True)
        del host._exact_rows
        assert _cuda.LAUNCHES["cell_bin"] == _cuda.LAUNCHES["cell_answer"] == 0
        assert COUNTS["cells.device_staged_rows"] == before
        _cuda.reset_launches()
        before = dict(COUNTS)
        got, cov = single.query_queue(queue, return_coverage=True)
        launches = dict(_cuda.LAUNCHES)
        scanned = [b for b in queue if len(b) and single.stage(b)[0] is not None]
        assert launches["cell_scan"] == len(scanned)
        assert launches["cell_bin"] == launches["cell_place"] == launches["cell_answer"] == 1
        assert launches["fused_argmin"] == COUNTS["cells.exact_calls"] - before[
            "cells.exact_calls"] == int(min(cov) < 1.0)
        assert COUNTS["cells.device_staged_rows"] - before["cells.device_staged_rows"] == sum(
            len(b) for b in queue if single.stage(b)[2] is not None)
        assert cov == cov_h
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        idx, counts, listed = _answer_kernel(single, single._bin(queue))
        np.testing.assert_array_equal(idx.cpu().numpy(), np.concatenate([i for i, _ in seen]))
        assert counts.tolist() == [int(ok.sum()) for _, ok in seen]
        np.testing.assert_array_equal(listed, np.flatnonzero(~np.concatenate(
            [ok for _, ok in seen])))


def _answer_kernel(eng, binned, answer=None):
    """Run ``cell_answer`` (or ``answer``, with its arguments) over each
    part of a binned queue after its scans: (idx (rows,) i32 on the
    device, each batch's certified count, the sorted uncertified rows)."""
    from nns_tpu_torch.kernels.cell_list import cell_answer

    answer = answer or cell_answer
    rows, batches = binned.rows, len(binned.plan)
    idx = torch.full((len(rows),), -7, dtype=torch.int32, device=rows.device)
    bad = torch.full((len(rows),), -1, dtype=torch.int32, device=rows.device)
    counts = torch.zeros(batches + 1, dtype=torch.int32, device=rows.device)
    max_rows = int(np.diff(binned.ends).max())
    eng._scan_parts(binned, lambda a, b, plan, win, slot: answer(
        rows, binned.offs[a:b + 1], max_rows, plan, win, slot, (2.0 * eng.halo) ** 2, idx,
        counts[a:b], bad, counts[batches:]))
    counts, bad = counts.cpu(), bad.cpu()
    listed = int(counts[-1])
    assert (bad[listed:] == -1).all() and len(torch.unique(bad[:listed])) == listed
    return idx, counts[:-1], np.sort(bad[:listed].numpy())


def _answer_case(case, cuda, rng):
    """(engine, queue) for the answer kernel: "uniform" 8 uniform 10K
    batches; "mixed" the binning kernels' mixed queue (uniform, faces,
    outside, a batch above the skew limit, an empty one) with rows over the
    box [-0.5, 1.5] and sentinel-corner rows; "clustered" 8 10K batches
    with 600 rows each in one small box (q_max 1024, so the tables take
    several parts) and a batch above the skew limit; "near_corner" refs and
    queries near the PAD_SENTINEL corner, with the corner rows."""
    n = 1 << 20 if case == "clustered" else 65536
    if case == "near_corner":
        r = np.float32(1e6) - rng.random((n, 3), dtype=np.float32) * np.float32(64.0)
    else:
        _, r = make_dataset(3, 1, n, seed=25)
    eng = CellListEngine(r, device=cuda)
    lo, extent = r.min(axis=0), r.max(axis=0) - r.min(axis=0)
    uniform = [(lo + rng.random((10_000, 3), dtype=np.float32) * extent).astype(np.float32)
               for _ in range(8)]
    if case == "uniform":
        return eng, uniform
    if case == "mixed":
        ood = (rng.random((3000, 3), dtype=np.float32) * np.float32(2.0)
               - np.float32(0.5)).astype(np.float32)
        return eng, _bin_queue_case("mixed", eng, rng) + [ood, corner_rows(eng)]
    if case == "near_corner":
        return eng, uniform[:2] + [corner_rows(eng), uniform[2][:50]]
    for b, qb in enumerate(uniform):
        qb[:600] = np.float32(0.1 * b + 0.05) + qb[:600] * np.float32(0.004)
    too_skewed = (np.float32(0.5) + rng.random((2 * eng.q_max_limit() + 10, 3), dtype=np.float32)
                  * np.float32(1e-4)).astype(np.float32)
    return eng, uniform[:4] + [too_skewed] + uniform[4:]


ANSWER_CASES = ["uniform", "mixed", "clustered", "near_corner"]


@pytest.mark.parametrize("case", ANSWER_CASES)
def test_cell_answer_kernel_equals_twin(cuda, case):
    # cell_answer's kernel against cell_answer_plain on the same card
    # tensors (each part's winners and slots after its scans): idx bit-equal
    # at every row, each batch's certified count and the set of uncertified
    # rows equal; one launch per part.
    from nns_tpu_torch.kernels.cell_list import cell_answer_plain

    eng, queue = _answer_case(case, cuda, np.random.default_rng(26))
    binned = eng._bin(queue)
    _cuda.reset_launches()
    idx, counts, listed = _answer_kernel(eng, binned)
    assert _cuda.LAUNCHES["cell_answer"] == max(len(binned.parts), 1)
    if case == "clustered":
        assert len(binned.parts) > 1 and binned.skewed.any()
    t_idx, t_counts, t_listed = _answer_kernel(
        eng, binned, lambda rows, offs, max_rows, *rest: cell_answer_plain(rows, offs, *rest))
    assert torch.equal(idx, t_idx), f"{int((idx != t_idx).sum())} rows differ"
    assert torch.equal(counts, t_counts)
    np.testing.assert_array_equal(listed, t_listed)
    assert len(listed) > 0 or case == "uniform"


@pytest.mark.parametrize("case", ANSWER_CASES)
def test_query_queue_on_card_equals_host_tail(cuda, case):
    # The CUDA drain answers on the card; the host tail (_answer_queue over
    # the same winners, gathered and downloaded as the drain did before)
    # gives the same answers and coverages row for row. One answer launch
    # per part, at most one exact call per queue (and one v4 launch with
    # it), every row answered by the kernel.
    from nns_tpu_torch.utils.spans import COUNTS

    eng, queue = _answer_case(case, cuda, np.random.default_rng(27))
    binned = eng._bin(queue)
    want, cov_want = eng._answer_queue(queue, eng._signed_rows(binned), [None] * len(queue),
                                       True)
    _cuda.reset_launches()
    before = dict(COUNTS)
    got, cov = eng.query_queue(queue, return_coverage=True)
    grew = {name: COUNTS[name] - before[name] for name in COUNTS}
    assert cov == cov_want
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    rows = sum(len(b) for b in queue)
    assert grew["cells.device_answered_rows"] == grew["cells.rows"] == rows
    assert grew["cells.exact_calls"] == _cuda.LAUNCHES["fused_argmin"] == int(min(cov) < 1.0)
    assert _cuda.LAUNCHES["cell_answer"] == max(len(binned.parts), 1)
    assert grew["cells.certified_rows"] == round(sum(c * len(b) for c, b in zip(cov, queue)))


def test_engine_auto_feeds_the_hysteresis_the_host_tails_coverage(cuda):
    # NNEngine("auto").query_many on the card feeds _note_cell_coverage the
    # host tail's per-batch coverage and row count, and answers exactly.
    _, r = make_dataset(3, 1, 65536, seed=28)
    eng = NNEngine("auto", device="cuda").build(r)
    cell = eng._built
    assert type(cell) is CellListEngine
    rng = np.random.default_rng(28)
    queue = [rng.random((2000, 3), dtype=np.float32),
             (rng.random((2000, 3), dtype=np.float32) * np.float32(2.0)
              - np.float32(0.5)).astype(np.float32),
             rng.random((500, 3), dtype=np.float32)]
    _, covs = cell._answer_queue(queue, cell._signed_rows(cell._bin(queue)), [None] * 3, True)
    assert min(covs) < 1.0
    fed = []
    note = eng._note_cell_coverage
    eng._note_cell_coverage = lambda cov, m: fed.append((cov, m)) or note(cov, m)
    got = eng.query_many(queue)
    assert fed == [(c, len(q)) for c, q in zip(covs, queue)]
    for idx, q in zip(got, queue):
        assert recall_at_1(idx, q, r) == 1.0


def test_engine_query_many_on_card_checks_finiteness_in_the_bin_pass(cuda):
    # NNEngine(14).query_many on the card makes no host pass over the
    # queue: a NaN in the last row of its last batch raises ValueError after
    # the one bin launch, before any place, scan, answer or exact launch,
    # with every row counted as checked. A finite queue is answered
    # exactly, in int32 views of the drain's one download.
    from nns_tpu_torch.utils.spans import COUNTS

    _, r = make_dataset(3, 1, 65536, seed=29)
    eng = NNEngine(14, device="cuda").build(r)
    assert type(eng._built) is CellListEngine
    rng = np.random.default_rng(29)
    queue = [rng.random((2000, 3), dtype=np.float32) for _ in range(8)]
    bad = [q.copy() for q in queue]
    bad[-1][-1, 0] = np.nan
    _cuda.reset_launches()
    before = dict(COUNTS)
    with pytest.raises(ValueError, match="non-finite"):
        eng.query_many(bad)
    assert _cuda.LAUNCHES["cell_bin"] == 1
    assert [_cuda.LAUNCHES[name] for name in ("cell_place", "cell_scan", "cell_answer",
                                              "fused_argmin")] == [0, 0, 0, 0]
    assert COUNTS["cells.device_checked_rows"] - before["cells.device_checked_rows"] == 16000
    assert COUNTS["cells.rows"] == before["cells.rows"]
    before = dict(COUNTS)
    got = eng.query_many(queue)
    assert (COUNTS["cells.device_checked_rows"] - before["cells.device_checked_rows"]
            == COUNTS["cells.rows"] - before["cells.rows"] == 16000)
    for idx, q in zip(got, queue, strict=True):
        assert idx.dtype == np.int32 and idx.base is got[0].base is not None
        assert recall_at_1(idx, q, r) == 1.0


def test_device_binned_drain_in_parts_equals_host_staged_drain(cuda):
    # A clustered queue whose tables pass the drain's slot budget: one bin
    # launch, one place launch per part (queue_parts), one scan per batch;
    # the answers and the coverage bit-equal to the host-staged drain's;
    # the drain's device memory above what it held before stays within
    # the budget's 20 bytes a slot plus what its rows take.
    import nns_tpu_torch.kernels.cell_list as cl
    from nns_tpu_torch.parallel import Mesh, ShardedCellEngine

    _, r = make_dataset(3, 1, 1 << 20, seed=24)
    single = CellListEngine(r, device=cuda)
    host = ShardedCellEngine(r, Mesh.virtual(1, "cuda"))
    rng = np.random.default_rng(24)
    queue = []
    for b in range(8):
        qb = rng.random((10_000, 3), dtype=np.float32)
        qb[:600] = np.float32(0.1 * b + 0.05) + qb[:600] * np.float32(0.004)
        queue.append(qb)
    q_max = np.array([single.stage(b)[2] for b in queue])
    assert (q_max == 1024).all()
    _, parts = cl.queue_parts(q_max, single.D ** 3, cl._QUEUE_SLOTS)
    assert len(parts) > 1
    want, cov_want = host.query_queue(queue, return_coverage=True)
    single.query_queue(queue)  # warm: the fallback engine is built at its first use
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    _cuda.reset_launches()
    got, cov = single.query_queue(queue, return_coverage=True)
    grew = torch.cuda.max_memory_allocated(cuda) - held
    assert _cuda.LAUNCHES["cell_bin"] == 1
    assert _cuda.LAUNCHES["cell_place"] == len(parts)
    assert _cuda.LAUNCHES["cell_scan"] == len(queue)
    assert cov == cov_want
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    rows = sum(len(b) for b in queue)
    assert grew < 20 * cl._QUEUE_SLOTS + 64 * rows + 4 * len(queue) * single.D ** 3 + (8 << 20)
    assert grew < 20 * int(single.D ** 3 * q_max.sum()) // 2


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


def _has_plan(kp, ts):
    return phase1_plan(kp, ts, _cuda.smem_optin(_cuda.library())) is not None


def _counts():
    return _cuda.LAUNCHES["expansion_phase1"]


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


@pytest.mark.parametrize("m,n,k,tile_n,ts", [(1, 300, 16, 128, 64), (33, 777, 16, 128, 128),
                                             (1000, 70000, 16, 4096, 256),
                                             (300, 5000, 16, 512, 256),
                                             (300, 9000, 32, 1024, 256),
                                             (129, 20000, 48, 1024, 256),
                                             (129, 20000, 8, 1024, 256),
                                             (33, 777, 10, 128, 128),
                                             (300, 9000, 24, 1024, 256),
                                             (33, 777, 24, 128, 64),
                                             (17, 3000, 24, 640, 640),
                                             (200, 9000, 40, 1024, 128),
                                             (100, 9000, 40, 1024, 256),
                                             (200, 9000, 88, 1024, 256),
                                             (130, 9000, 96, 1024, 256),
                                             (300, 9000, 96, 1024, 256),
                                             (301, 9000, 96, 1024, 64),
                                             (300, 9000, 128, 1024, 256),
                                             (129, 5000, 128, 512, 64),
                                             (130, 5000, 128, 512, 128),
                                             (64, 3000, 200, 1024, 256),
                                             (64, 3000, 200, 1024, 64)])
def test_phase1_wgmma_kernel_within_delta_of_plain(cuda, m, n, k, tile_n, ts):
    # Every kp: 16-aligned with the query tile resident, 8 more than a
    # multiple of 16 (8, 24, 40, 88: each block padded with zero dims), and
    # past a resident tile (128, 200: dimension slices of up to 48); k = 10
    # pads to kp = 16 with zero dims.
    q, r = make_dataset(k, m, n, seed=400 + m + k)
    eng, delta, args = _phase1_args(q, r, tile_n, ts, cuda)
    assert _has_plan(eng.kp, ts)
    before = _counts()
    got = phase1(*args, rc_t=eng.rc_t)
    assert _counts() == before + 1
    assert_phase1_close(got, phase1_plain(*args), delta)


def test_phase1_wgmma_route_needs_rc_t(cuda):
    # The wgmma kernels read the engine's rc_t; without it phase1 raises
    # instead of transposing rc on every call.
    q, r = make_dataset(16, 20, 3000, seed=5)
    _, _, args = _phase1_args(q, r, 1024, 256, cuda)
    before = _counts()
    with pytest.raises(ValueError, match="rc_t"):
        phase1(*args)
    assert _counts() == before


@pytest.mark.parametrize("ts", [64, 128, 192, 256, 320, 640])
def test_phase1_plan_agrees_with_the_kernel_library(cuda, ts):
    # phase1_plan (host) and wgmma_setup (csrc/expansion_phase1.cu) state
    # the same rule: every shape the host has a plan for, the library
    # takes, and it refuses every other.
    lib = _cuda.library()
    for kp in range(8, 265, 8):
        blocks = ctypes.c_int()
        rc = lib.nns_expansion_phase1_wgmma_blocks_per_sm(kp, ts, ctypes.byref(blocks))
        assert (rc == 0) == _has_plan(kp, ts), (kp, ts, rc)
        assert rc != 0 or blocks.value >= 1
    # Every kp the engine makes has a plan; none where kp % 8 != 0 or
    # ts % 64 != 0, and the host says so.
    assert all(_has_plan(kp, ts) for kp in range(8, 265, 8))
    for kp, bad_ts in ((12, ts), (16, ts + 32)):
        rc = lib.nns_expansion_phase1_wgmma_blocks_per_sm(kp, bad_ts, ctypes.byref(blocks))
        assert rc != 0 and not _has_plan(kp, bad_ts), (kp, bad_ts)


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
    assert _has_plan(kp, ts)
    slots = _phase1_slots(_cuda.library(), kp, cuda, ts)
    assert phase1_splits(m, -(-n // tile_n), slots) > 1
    eng, _, args = _phase1_args(q, r, tile_n, ts, cuda)
    before = _counts()
    got, want = phase1(*args, rc_t=eng.rc_t), phase1_plain(*args)
    assert _counts() == before + 1
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
    assert (eng.kp, eng.ts) == (96, 64) and _has_plan(eng.kp, eng.ts)
    assert eng.rc_t.is_contiguous() and eng.rc.data_ptr() == eng.rc_t.data_ptr()
    before = _counts()
    got = eng.query(q)
    assert _counts() == before + 1
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
    assert _counts() == before + 1
    r_dm, _ = prepare_refs(r, 4096, cuda)
    _, want = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, r.shape[0])
    np.testing.assert_array_equal(got, want.cpu().numpy())
    assert recall_at_1(got, q, r) == 1.0


# -- The tree family, k-NN and persistence on the card ------------------------


def _fused_launches():
    return _cuda.LAUNCHES["fused_argmin"]


@pytest.mark.parametrize("family", ["kd", "octree"])
def test_beam_fallback_and_chunk_scan_launch_v4(cuda, family):
    # The beam's exact fallback and (on the KD frontier) its chunk scan run
    # the v4 kernel on the card; answers equal the CPU path's at recall 1.0.
    from nns_tpu_torch.trees.beam import kd_beam_index, octree_beam_index
    from nns_tpu_torch.trees.kdtree import KDTree
    from nns_tpu_torch.trees.octree import Octree

    q, r = make_dataset(3, 3000, 65536, seed=21, clustered=True, query_box=(-0.3, 1.3))
    tree = KDTree.build(r) if family == "kd" else Octree.build(r)
    make = kd_beam_index if family == "kd" else octree_beam_index
    gpu, cpu = make(tree, device=cuda), make(tree, device="cpu")
    before = _fused_launches()
    idx, cov = gpu.query_with_coverage(q, beam=2)
    assert cov < 1.0 and _fused_launches() > before
    assert recall_at_1(idx, q, r) == 1.0
    cidx, ccov = cpu.query_with_coverage(q, beam=2)
    assert cov == ccov
    np.testing.assert_array_equal(gpu.query_with_flags(q, 2)[1], cpu.query_with_flags(q, 2)[1])
    if family == "kd":
        st = gpu.stage_queries(q)
        before = _fused_launches()
        sidx, sok = gpu.query_staged_scan_with_flags(st, 16)
        assert _fused_launches() - before == st.q_dev.shape[0]  # one launch per chunk
        cidx, cok = cpu.query_staged_scan_with_flags(cpu.stage_queries(q), 16)
        np.testing.assert_array_equal(sok, cok)
        np.testing.assert_array_equal(sidx[sok], cidx[sok])
        out, _ = gpu.query_staged_with_coverage(st, beam=8, budget=16)
        assert recall_at_1(out, q, r) == 1.0


@pytest.mark.parametrize("version", [10, 11, 12, 13])
@pytest.mark.parametrize("k", [3, 5])
def test_tree_versions_on_card(cuda, version, k):
    from nns_tpu_torch import nns

    q, r = make_dataset(k, 1000, 50_000, seed=version, clustered=True)
    got = nns(q, r, version=version, device="cuda")
    assert recall_at_1(got, q, r) == 1.0
    eng = NNEngine(version, device="cuda").build(r)
    assert recall_at_1(np.concatenate(eng.query_many([q[:400], q[400:]])), q, r) == 1.0


def test_topk_on_card_equals_cpu(cuda):
    from nns_tpu_torch.kernels.topk import nns_topk

    q, r = make_dataset(3, 2000, 65536, seed=22, query_box=(-0.2, 1.2))
    for k_nn in (1, 8):
        a = CellListEngine(r, device=cuda).query_topk(q, k_nn)
        b = CellListEngine(r, device="cpu").query_topk(q, k_nn)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(nns_topk(q[:300], r, k_nn, device=cuda),
                        nns_topk(q[:300], r, k_nn, device="cpu")):
            np.testing.assert_array_equal(x, y)


def test_promotion_and_save_load_on_card(cuda, tmp_path):
    # A v14 engine promotes to the beam index on the card, saves it, and the
    # loaded engine answers the same.
    from nns_tpu_torch.trees.beam import BeamIndex

    rng = np.random.default_rng(25)
    centers = rng.random((64, 3)).astype(np.float32)
    r = (centers[rng.integers(0, 64, 65536)]
         + rng.normal(0, 0.003, (65536, 3))).astype(np.float32)
    eng = NNEngine(14, device="cuda").build(r)
    assert isinstance(eng._built, CellListEngine)
    q = rng.random((256, 3), dtype=np.float32)
    for _ in range(2):
        assert recall_at_1(eng.query(q), q, r) == 1.0
    assert isinstance(eng._built, BeamIndex) and eng._built.device.type == "cuda"
    path = str(tmp_path / "beam.npz")
    eng.save(path)
    loaded = NNEngine.load(path, 14, device="cuda")
    np.testing.assert_array_equal(loaded.query(q), eng.query(q))
    for version in (10, 11, 12, 13, 14):
        e = NNEngine(version, device="cuda").build(r)
        e.save(path)
        np.testing.assert_array_equal(NNEngine.load(path, version, device="cuda").query(q),
                                      e.query(q))


# -- the multi-device layer on a virtual four-shard mesh of the card ----------


@pytest.mark.parametrize("k,m,n", [(3, 300, 70001), (16, 64, 5000)])
def test_sharded_and_ring_on_a_virtual_mesh_equal_v4(cuda, k, m, n):
    # Four shards, four v4 launches and the merge on one card; the 2-D
    # (2, 2) mesh and the ring too. Each answer equals the single-device v4
    # kernel's, and launches the kernel once per shard (per ring step).
    from nns_tpu_torch.parallel import Mesh, ring_argmin, sharded_argmin, sharded_argmin_2d

    q, r = make_dataset(k, m, n, seed=k + m)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    want = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, n)[1]
    mesh = Mesh.virtual(4, "cuda")
    _cuda.reset_launches()
    got = sharded_argmin(q, r, mesh)
    assert _cuda.LAUNCHES["fused_argmin"] == 4 and got.device == want.device
    assert torch.equal(got, want)
    assert torch.equal(sharded_argmin_2d(q, r, Mesh.virtual((2, 2), "cuda")), want)
    _cuda.reset_launches()
    assert torch.equal(ring_argmin(q, r, mesh), want)
    assert _cuda.LAUNCHES["fused_argmin"] == 16


@pytest.mark.parametrize("n_shards", [4, 5])
def test_sharded_cells_on_a_virtual_mesh_equal_single_device(cuda, tmp_path, n_shards):
    # G = 216 groups: four shards of 54, or five of 44 with four padding
    # groups (zero query rows on the card).
    from nns_tpu_torch.parallel import Mesh, ShardedCellEngine

    q, r = make_dataset(3, 3000, 65536, seed=8)
    batches = [q[:1000], q[1000:], (q[:400] * np.float32(0.05)).astype(np.float32),
               (q[:500] * np.float32(2.0) - np.float32(0.5)).astype(np.float32)]
    single = CellListEngine(r, device=cuda)
    sharded = ShardedCellEngine(r, Mesh.virtual(n_shards, "cuda"))
    assert single.D ** 3 == 216 and sharded.g_pad == 216 + (n_shards == 5) * 4
    _cuda.reset_launches()
    got, cov = sharded.query_queue(batches, return_coverage=True)
    # One launch per shard that holds rows of a batch.
    busy = sum(int((np.diff(sharded._shard_cuts(sharded.stage(b)[0])) > 0).sum())
               for b in batches)
    assert _cuda.LAUNCHES["cell_scan"] == busy
    want, cov_s = single.query_queue(batches, return_coverage=True)
    assert cov == cov_s and min(cov) < 1.0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    denses, _, _ = single.stage_queue_ragged(batches)
    G = single.D ** 3
    for t, t_s in zip(sharded.query_queue_staged(denses), single.query_queue_staged(denses)):
        assert torch.equal(t[:G], t_s)
    tokens = [sharded.query_submit(b) for b in batches[:2]]
    for b, t in zip(batches[:2], tokens):
        for x, y in zip(sharded.query_collect(t), single.query_with_flags(b)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(sharded.query_topk(q[:500], 8), single.query_topk(q[:500], 8)):
        np.testing.assert_array_equal(x, y)
    path = str(tmp_path / "cells.npz")
    sharded.save(path)
    np.testing.assert_array_equal(
        ShardedCellEngine.load(path, Mesh.virtual(2, "cuda")).query(q), single.query(q))
