"""v9 of the PyTorch port (kernels/mxu_expansion.py, NNEngine(9)) against the
JAX package, on CPU torch (the plain versions). Numpy makes each seeded
input once and both packages get the same arrays; the JAX side runs its
Pallas phase 1 in interpret mode, as tests/test_mxu_expansion.py runs it.

Tolerances, stated per assertion:
- splits and staged arrays: byte-equal;
- phase 1: tid2 equal, t3v within the engine's delta (the two packages sum
  the bf16 products in different orders);
- query_min_idx_cert: idx and cert equal, min1 within delta;
- every index array from nns / NNEngine / query: exactly equal;
- the kernel's range-and-merge algorithm (mirrored in Python here) against
  phase1_plain: all six outputs exactly equal, on integer data where every
  sum is exact in any order.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nns_tpu
import nns_tpu.kernels.mxu_expansion as J
import nns_tpu_torch
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu_torch.convert import mxu_engine_from_numpy
from nns_tpu_torch.kernels import _cuda
from nns_tpu_torch.kernels import mxu_expansion as P
from nns_tpu_torch.kernels.fused import FusedBruteForce
from nns_tpu_torch.kernels.oracle import recall_at_1
from test_torch_native import native_libraries  # noqa: F401  (the guard)

# The JAX package's host library loaded in this process: the high-k probe
# builds a KD tree through it (tests/test_torch_native.py).
pytestmark = pytest.mark.usefixtures("native_libraries")


def _pair(refs, tile_m=8, tile_n=128):
    return (J.MXUExpansion(refs, tile_m=tile_m, tile_n=tile_n),
            P.MXUExpansion(refs, tile_n=tile_n, device="cpu"))


def _oracle(queries, refs):
    d = ((queries[:, None, :].astype(np.float64) - refs[None].astype(np.float64)) ** 2).sum(-1)
    return d.argmin(1)


def _bits(x):
    return x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) else np.asarray(x).view(np.int16)


# ---------------------------------------------------------------------------
# splits, staging, phase 1
# ---------------------------------------------------------------------------


def test_split_bf16x3_byte_equal():
    # Byte-equal splits, and the triple carries ~24 bits (the residual of
    # hi alone is far larger).
    x = np.random.default_rng(0).random((64, 16), dtype=np.float32) * 7 - 3
    ours = P.split_bf16x3(torch.from_numpy(x))
    theirs = J._split_bf16x3(jnp.asarray(x))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    hi, mid, lo = (t.double() for t in ours)
    assert float((torch.from_numpy(x).double() - hi).abs().max()) > 1e-4
    assert float((torch.from_numpy(x).double() - hi - mid - lo).abs().max()) < 1e-6


@pytest.mark.parametrize("k,n,tile_n", [(16, 1000, 128), (10, 3000, 1024), (16, 2000, 640)])
def test_staging_byte_equal(k, n, tile_n):
    refs = make_dataset(k, 1, n, seed=n)[1]
    je, pe = _pair(refs, tile_n=tile_n)
    assert (pe.kp, pe.tile_n, pe.ts) == (je.kp, je.tile_n, je.ts)
    np.testing.assert_array_equal(_bits(pe.rc), _bits(je.rc))
    for name in ("r2h", "refs_t", "r2h_t"):
        np.testing.assert_array_equal(getattr(pe, name).numpy(), np.asarray(getattr(je, name)))


@pytest.mark.parametrize("k,n,tile_n", [(16, 1000, 128), (10, 3000, 1024), (16, 3000, 512)])
def test_phase1_plain_equals_jax(k, n, tile_n):
    # Tolerance: tid2 equal, t3v within delta (summation order differs).
    q, refs = make_dataset(k, 70, n, seed=k + n)
    je, pe = _pair(refs, tile_m=32, tile_n=tile_n)
    st = pe.stage_queries(q)
    _, _, _, tid2_j, t3v_j = J._phase12(
        jnp.asarray(q), je.rc, je.r2h, je.refs_t, je.r2h_t, jnp.float32(st.delta), je.kp,
        je.tile_m, je.tile_n, je.ts, True)
    qc = P._cat_q(*P.split_bf16x3(st.q_dev))
    _, _, _, _, tid2, t3v = P.phase1(qc, pe.rc, pe.r2h, pe.tile_n, pe.ts)
    np.testing.assert_array_equal(tid2.numpy(), np.asarray(tid2_j)[:70, 0])
    t3j = np.asarray(t3v_j)[:70, 0]
    fin = np.isfinite(t3j)
    np.testing.assert_array_equal(np.isfinite(t3v.numpy()), fin)
    assert np.abs(t3v.numpy()[fin] - t3j[fin]).max() <= st.delta


# The CUDA kernel's algorithm, mirrored: each range of whole tiles scans its
# subtiles incrementally into (tmin, lowest subtile, runner-up), updates the
# six carries per tile, and the ranges are merged in ascending order
# (csrc/expansion_phase1.cu, the wgmma kernels' epilogue and
# phase1_merge_kernel).


def _range_state(e, j0, j1, tile_n, ts):
    ns = tile_n // ts
    min1, tid, m2x, t2v, tid2, t3v = np.inf, 0, np.inf, np.inf, 0, np.inf
    for j in range(j0, j1):
        tmin, smin2, sarg = np.inf, np.inf, 0
        for c in range(ns):
            lo = j * tile_n + c * ts
            smin = e[lo:lo + ts].min()
            if smin < tmin:
                smin2, tmin, sarg = min(smin2, tmin), smin, c
            else:
                smin2 = min(smin2, smin)
        b1 = tmin < min1
        b2 = not b1 and tmin < t2v
        n2v = min1 if b1 else (tmin if b2 else t2v)
        nid2 = tid // ns if b1 else (j if b2 else tid2)
        n3v = t2v if (b1 or b2) else min(t3v, tmin)
        m2x = min(min1, smin2) if b1 else min(m2x, tmin)
        if b1:
            min1, tid = tmin, j * ns + sarg
        t2v, tid2, t3v = n2v, nid2, n3v
    return [min1, tid, m2x, t2v, tid2, t3v]


def _merge(L, R, ns):
    (l1, lt, lm2, l2, li2, l3), (r1, rt, rm2, r2, ri2, r3) = L, R
    lv, li = [l1, l2, l3], [lt // ns, li2]
    rv, ri = [r1, r2, r3], [rt // ns, ri2]
    ov, oi, a, b = [], [], 0, 0
    for p in range(3):
        if lv[a] <= rv[b]:
            ov.append(lv[a])
            oi.append(li[a] if p < 2 else None)
            a += 1
        else:
            ov.append(rv[b])
            oi.append(ri[b] if p < 2 else None)
            b += 1
    if r1 < l1:
        m2x, min1, tid = min(rm2, l1), r1, rt
    else:
        m2x, min1, tid = min(lm2, r1), l1, lt
    return [min1, tid, m2x, ov[1], oi[1], ov[2]]


@pytest.mark.parametrize("tile_n,ts,per", [(128, 128, 1), (512, 128, 2), (512, 256, 3),
                                           (256, 64, 5)])
def test_kernel_range_merge_equals_sequential(tile_n, ts, per):
    # Integer coordinates: every product and sum is exact in any order, so
    # the mirror and phase1_plain must agree exactly. Exact duplicates of
    # each query's nearest point sit in other ranges and tiles, plus whole
    # duplicated tiles, so the tie rules are all exercised; n leaves padded
    # subtiles in the last tile.
    rng = np.random.default_rng(tile_n + ts + per)
    k, n, m = 16, 2900, 24
    refs = rng.integers(0, 4, (n, k)).astype(np.float32)
    q = rng.integers(0, 4, (m, k)).astype(np.float32)
    for i in range(m):
        near = int(_oracle(q[i:i + 1], refs)[0])
        for dup in (near + 700, near + 1500, (near * 7) % n):
            refs[dup % n] = refs[near]
    refs[tile_n:2 * tile_n] = refs[:tile_n]  # two identical tiles
    eng = P.MXUExpansion(refs, tile_n=tile_n, tile_s=ts, device="cpu")
    qc = P._cat_q(*P.split_bf16x3(eng.stage_queries(q).q_dev))
    want = [t.numpy() for t in P.phase1_plain(qc, eng.rc, eng.r2h, tile_n, ts)]
    rows = torch.cat([eng.rc[s * eng.kp:(s + 1) * eng.kp] for s in P._SPLIT_OF_BLOCK]).double()
    e = (eng.r2h.double() - qc.double() @ rows).numpy()
    n_tiles = eng.rc.shape[1] // tile_n
    ns = tile_n // ts
    for i in range(m):
        states = [_range_state(e[i], j, min(n_tiles, j + per), tile_n, ts)
                  for j in range(0, n_tiles, per)]
        got = states[0]
        for s in states[1:]:
            got = _merge(got, s, ns)
        assert got == [float(want[0][i]), int(want[1][i]), float(want[2][i]),
                       float(want[3][i]), int(want[4][i]), float(want[5][i])], i


def test_engine_keeps_rc_t():
    # The wgmma kernel's K-major ref operand, on every device: the engine
    # keeps rc_t alone, contiguous and byte-equal to the JAX engine's rc
    # transposed, and rc only as a view of it, in a built engine and in one
    # made from staged arrays (the JAX layout, transposed once). Both answer
    # as the JAX engine does.
    q, refs = make_dataset(16, 50, 900, seed=2)
    je = J.MXUExpansion(refs, tile_m=8, tile_n=128)
    want = np.ascontiguousarray(_bits(je.rc).T)
    eng = P.MXUExpansion(refs, tile_n=128, device="cpu")
    rc = torch.from_numpy(_bits(je.rc).copy()).view(torch.bfloat16)
    staged = P.MXUExpansion.from_staged(refs, rc, eng.r2h, eng.refs_t, eng.r2h_t, eng.tile_n,
                                        eng.ts, device="cpu")
    for e in (eng, staged):
        assert e.rc_t.shape == (want.shape[0], 3 * e.kp) and e.rc_t.is_contiguous()
        np.testing.assert_array_equal(_bits(e.rc_t), want)
        assert e.rc.data_ptr() == e.rc_t.data_ptr() and not e.rc.is_contiguous()
        np.testing.assert_array_equal(_bits(e.rc.contiguous()), _bits(je.rc))
        # One ref layout: no other bf16 tensor is kept beside rc_t.
        kept = [v for v in vars(e).values()
                if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16]
        assert len(kept) == 1 and kept[0] is e.rc_t
    np.testing.assert_array_equal(eng.query(q), np.asarray(je.query(q)))
    np.testing.assert_array_equal(staged.query(q), eng.query(q))


# The H100's opt-in shared memory per block (227 KB).
_H100_OPTIN = 232_448


@pytest.mark.parametrize("kp,ts,optin,expected", [
    (16, 256, _H100_OPTIN, True), (16, 64, _H100_OPTIN, True),
    (32, 256, _H100_OPTIN, True), (48, 1024, _H100_OPTIN, True),
    (64, 256, _H100_OPTIN, True),
    (8, 256, _H100_OPTIN, True), (24, 256, _H100_OPTIN, True),  # padded to kp16
    (80, 256, _H100_OPTIN, True),       # 128-column chunks 246,784 bytes; 64: 184,832
    (80, 64, _H100_OPTIN, True),        # 64-column chunks: 184,832 bytes
    (96, 64, _H100_OPTIN, True),        # resident, 221,696 bytes
    (96, 192, _H100_OPTIN, True), (96, 256, _H100_OPTIN, True),
    (128, 256, _H100_OPTIN, True),      # the sliced case
    (16, 640, _H100_OPTIN, True), (16, 100, _H100_OPTIN, False),  # ts % 64 != 0
    (16, 256, 48 * 1024, True),         # 64-column chunks fit a 48 KB card: 37,376 bytes
    (12, 256, _H100_OPTIN, False),      # kp % 8 != 0 (the engine pads k to 8)
])
def test_phase1_route_by_shape(kp, ts, optin, expected):
    # Every kp the engine makes (a multiple of 8) has a wgmma plan wherever
    # ts % 64 == 0; where there is none, phase 1 on the card raises.
    assert (P.phase1_plan(kp, ts, optin) is not None) == expected


@pytest.mark.parametrize("kp,ts,plan", [
    (16, 256, (128, 16, 1, True, 50_176)), (24, 256, (128, 32, 1, True, 99_328)),
    (40, 64, (64, 48, 1, True, 111_104)),
    (80, 256, (64, 80, 1, True, 184_832)), (88, 256, (64, 96, 1, True, 221_696)),
    (96, 256, (64, 96, 1, True, 221_696)), (104, 256, (128, 16, 7, True, 197_632)),
    (128, 256, (128, 16, 8, True, 222_208)), (128, 64, (64, 32, 4, True, 221_696)),
    (136, 256, (128, 48, 3, False, 222_208)), (200, 256, (128, 48, 5, False, 222_208)),
    (200, 64, (64, 48, 5, False, 184_832)),
])
def test_phase1_plan_by_shape(kp, ts, plan):
    # The resident query tile up to kp16 = 96 where it fits beside the
    # ring; then the query tile still resident with the rc splits in slices
    # (kp16 = 112 and 128); past it query and rc slices of 48 dims, whose
    # ring fits at either chunk width; chunks of 128 columns where ts
    # allows and the plan fits.
    got = P.phase1_plan(kp, ts, _H100_OPTIN)
    assert (got.bn, got.ds, got.slices, got.query_resident, got.smem_bytes) == plan
    assert got.smem_bytes <= _H100_OPTIN and got.ds % 16 == 0 and got.ds * got.slices >= kp


def test_phase1_plan_covers_every_kp():
    # Every kp the engine makes, up to k = 4096, has a plan at the engine's
    # subtile widths, and at most 16 dims of padding per slice.
    for kp in range(8, 4097, 8):
        for ts in (64, 128, 192, 256):
            plan = P.phase1_plan(kp, ts, _H100_OPTIN)
            assert plan is not None and plan.smem_bytes <= _H100_OPTIN, (kp, ts)
            assert plan.slices * plan.ds - kp < 16 + plan.ds, (kp, ts)


def test_wgmma_chunk_and_smem_bytes():
    # 128-column chunks where ts allows; query tile 128 x 6 kp bf16, then 2
    # stages of (chunk, 3 kp) bf16 rows + chunk f32 half-norms.
    assert [P.wgmma_chunk(ts) for ts in (64, 128, 192, 256, 640)] == [64, 128, 64, 128, 128]
    assert P.wgmma_smem_bytes(16, 128) == 24_576 + 2 * (12_288 + 512) == 50_176
    assert P.wgmma_smem_bytes(16, 64) == 24_576 + 2 * (6_144 + 256) == 37_376
    assert P.wgmma_smem_bytes(64, 128) <= _H100_OPTIN < P.wgmma_smem_bytes(80, 128)


# The wgmma kernel's addressing, mirrored (csrc/expansion_phase1.cu,
# stage_canonical, smem_desc and the wgmma loop): tiles are staged K-major in the
# canonical no-swizzle layout, and each wgmma m64n64k16 reads its operands
# from a descriptor start with LBO 128 bytes along K and SBO 16 kc bytes
# along M or N.


def _core_offset(row, col, kc):
    """Byte offset of element (row, col) of a staged (rows, kc) tile."""
    return (row // 8) * (kc // 8) * 128 + (col // 8) * 128 + (row % 8) * 16 + (col % 8) * 2


def _stage(tile, kc):
    """A (rows, kc) tile as the kernel stages it: int16 words at their core
    offsets (each offset even, every word written once)."""
    rows = tile.shape[0]
    r, c = np.meshgrid(np.arange(rows), np.arange(kc), indexing="ij")
    off = _core_offset(r, c, kc)
    assert (off % 2 == 0).all() and len(np.unique(off)) == rows * kc
    buf = np.zeros(rows * kc, np.int16)
    buf[off // 2] = _bits(tile)
    return buf


def _a_start(wg, b, kk, kp):
    """Byte start of the A descriptor: warpgroup wg's 64 rows, columns
    b kp + kk of the (128, 6 kp) query tile."""
    return wg * 64 * 6 * kp * 2 + 16 * (b * kp + kk)


def _b_start(b, kk, kp):
    """Byte start of the B descriptor: columns split(b) kp + kk of the
    (chunk, 3 kp) rc_t chunk."""
    return 16 * (P._SPLIT_OF_BLOCK[b] * kp + kk)


def _read(buf, start, rows, kc):
    """The (rows, 16) bf16 operand a descriptor at byte `start` reads."""
    i, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    addr = start + (i // 8) * (16 * kc) + (k // 8) * 128 + (i % 8) * 16 + (k % 8) * 2
    return torch.from_numpy(buf[addr // 2].copy()).view(torch.bfloat16).double()


@pytest.mark.parametrize("k,m,n,ts", [(16, 130, 300, 128), (12, 40, 700, 64), (32, 70, 200, 128),
                                      (48, 9, 130, 64)])
def test_wgmma_addressing_reads_phase1_plain_cross(k, m, n, ts):
    # Integer data: every product and sum is exact in any order, so the
    # cross terms read through the mirrored descriptors from the engine's
    # staged rc_t must equal the plain version's qc @ [rh; rm; rh; rl; rh;
    # rm] exactly.
    rng = np.random.default_rng(k + m)
    refs = rng.integers(-3, 4, (n, k)).astype(np.float32)
    q = rng.integers(-3, 4, (m, k)).astype(np.float32)
    eng = P.MXUExpansion(refs, tile_n=128, tile_s=ts, device="cpu")
    kp, n_pad, bn, rc_t = eng.kp, eng.rc.shape[1], P.wgmma_chunk(ts), eng.rc_t
    assert P.phase1_plan(kp, eng.ts, _H100_OPTIN) is not None
    qc = P._cat_q(*P.split_bf16x3(eng.stage_queries(q).q_dev))
    rows = torch.cat([eng.rc[s * kp:(s + 1) * kp] for s in P._SPLIT_OF_BLOCK]).float()
    with P.full_fp32_matmul():
        want = (qc.float() @ rows).double()
    got = torch.zeros((m, n_pad), dtype=torch.float64)
    for q0 in range(0, m, P._KERNEL_BM):
        tile = torch.zeros((P._KERNEL_BM, 6 * kp), dtype=torch.bfloat16)
        tile[:min(P._KERNEL_BM, m - q0)] = qc[q0:q0 + P._KERNEL_BM]
        a_buf = _stage(tile, 6 * kp)
        for c0 in range(0, n_pad, bn):
            b_buf = _stage(rc_t[c0:c0 + bn], 3 * kp)
            for wg in range(2):
                acc = torch.zeros((64, bn), dtype=torch.float64)
                for b in range(6):
                    for kk in range(0, kp, 16):
                        a = _read(a_buf, _a_start(wg, b, kk, kp), 64, 6 * kp)
                        bt = _read(b_buf, _b_start(b, kk, kp), bn, 3 * kp)
                        acc += a @ bt.t()
                r0 = q0 + 64 * wg
                got[r0:min(m, r0 + 64), c0:c0 + bn] = acc[:max(0, min(64, m - r0))]
    assert torch.equal(got, want)


def _stage_slice(src, blocks, kp, d0, dn, ds, rows):
    """csrc/expansion_phase1.cu stage_slice, mirrored: dims [d0, d0 + dn)
    of the ``blocks`` blocks (block b at column b kp) of the bf16 rows of
    ``src`` into a K-major (rows, blocks ds) canonical tile, block b at
    column b ds, 16-byte segment by segment; zeros past dn and past the
    rows of ``src``. Returns the tile as int16 words."""
    words = _bits(src)
    seg_count = ds // 8
    buf = np.zeros(rows * blocks * ds, np.int16)
    r = np.arange(rows)
    for seg in range(blocks * seg_count):
        b, w = divmod(seg, seg_count)
        if 8 * w >= dn:
            continue  # a zero segment: cp.async with no source bytes
        off = (r // 8) * blocks * seg_count * 128 + seg * 128 + (r % 8) * 16
        for e in range(8):
            col = b * kp + d0 + 8 * w + e
            buf[(off[:len(words)] + 2 * e) // 2] = words[:, col]
    return buf


@pytest.mark.parametrize("k,m,n,ts,sliced", [(24, 130, 300, 256, False), (40, 70, 200, 64, False),
                                             (96, 9, 130, 256, True), (128, 40, 200, 128, True),
                                             (104, 20, 130, 64, True), (200, 9, 130, 64, True)])
def test_wgmma_padded_and_sliced_staging_reads_phase1_plain_cross(k, m, n, ts, sliced):
    # The wgmma kernels' staging of padded blocks (kp % 16 == 8: each block
    # and split padded with zeros to whole k16 steps) and of dimension
    # slices (units of (chunk, slice) holding the rc slice and, unless the
    # query tile stays resident, the query slice; the accumulator carried
    # across slices), mirrored on integer
    # data: every product and sum is exact in any order, so the cross terms
    # read through the descriptors must equal qc @ [rh; rm; rh; rl; rh; rm]
    # exactly. kp = 96 is resident on the H100 (64-column chunks); here it
    # also runs the sliced layout, as a smaller card would.
    rng = np.random.default_rng(k + m)
    refs = rng.integers(-3, 4, (n, k)).astype(np.float32)
    q = rng.integers(-3, 4, (m, k)).astype(np.float32)
    eng = P.MXUExpansion(refs, tile_n=128, tile_s=ts, device="cpu")
    kp, n_pad, rc_t = eng.kp, eng.rc.shape[1], eng.rc_t
    plan = P.phase1_plan(kp, eng.ts, _H100_OPTIN)
    if sliced and plan.slices == 1:
        plan = P.Phase1Plan(plan.bn, 48, -(-kp // 48), False, 0)
    assert (plan.slices > 1) == sliced
    ds, bn = plan.ds, plan.bn
    kd = ds * plan.slices if plan.query_resident else ds  # query dims per block staged
    qc = P._cat_q(*P.split_bf16x3(eng.stage_queries(q).q_dev))
    rows = torch.cat([eng.rc[s * kp:(s + 1) * kp] for s in P._SPLIT_OF_BLOCK]).float()
    with P.full_fp32_matmul():
        want = (qc.float() @ rows).double()
    got = torch.zeros((m, n_pad), dtype=torch.float64)
    for q0 in range(0, m, P._KERNEL_BM):
        for c0 in range(0, n_pad, bn):
            acc = torch.zeros((P._KERNEL_BM, bn), dtype=torch.float64)
            if plan.query_resident:
                a_buf = _stage_slice(qc[q0:q0 + P._KERNEL_BM], 6, kp, 0, kp, kd, P._KERNEL_BM)
            for s in range(plan.slices):
                d0 = s * ds
                dn = min(ds, kp - d0)
                if not plan.query_resident:
                    a_buf = _stage_slice(qc[q0:q0 + P._KERNEL_BM], 6, kp, d0, dn, ds,
                                         P._KERNEL_BM)
                a0 = d0 if plan.query_resident else 0  # slice s of the resident tile
                b_buf = _stage_slice(rc_t[c0:c0 + bn], 3, kp, d0, dn, ds, bn)
                for wg in range(2):
                    for b in range(6):
                        for kk in range(ds // 16):  # every step, zeros past dn
                            a = _read(a_buf, wg * 64 * 6 * kd * 2 + 16 * (a0 + b * kd + 16 * kk),
                                      64, 6 * kd)
                            bt = _read(b_buf, 16 * (P._SPLIT_OF_BLOCK[b] * ds + 16 * kk), bn,
                                       3 * ds)
                            acc[64 * wg:64 * wg + 64] += a @ bt.t()
            got[q0:q0 + P._KERNEL_BM, c0:c0 + bn] = acc[:min(P._KERNEL_BM, m - q0)]
    assert torch.equal(got, want)


def test_phase1_wrapper_checks_inputs():
    refs = make_dataset(16, 1, 300, seed=1)[1]
    eng = P.MXUExpansion(refs, tile_n=128, device="cpu")
    qc = P._cat_q(*P.split_bf16x3(torch.zeros((4, 16))))
    with pytest.raises(ValueError, match="nest"):
        P.phase1(qc, eng.rc, eng.r2h, 128, 100)
    with pytest.raises(ValueError, match="shape mismatch"):
        P.phase1(qc[:, :48], eng.rc, eng.r2h, 128, 128)
    with pytest.raises(TypeError):
        P.phase1(qc.float(), eng.rc, eng.r2h, 128, 128)
    meta = torch.empty(qc.shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        P.phase1(meta, eng.rc.to("meta"), eng.r2h.to("meta"), 128, 128)


def test_phase1_splits_fill_the_card():
    # One wave of (query tile, range) blocks on 396 slots (3 per SM x 132),
    # never more ranges than tiles, one range once query tiles fill a wave.
    assert P.phase1_splits(10_000, 245, 396) == 5
    assert P.phase1_splits(1024, 245, 396) == 49
    assert P.phase1_splits(33, 1, 396) == 1
    assert P.phase1_splits(640_000, 245, 396) == 1


# ---------------------------------------------------------------------------
# the engine against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n,tile_n", [(16, 1000, 128), (10, 3000, 1024), (16, 3000, 512),
                                        (12, 2000, 640), (128, 1000, 128)])
def test_query_min_idx_cert_equals_jax(k, n, tile_n):
    # Tolerance: idx and cert equal, min1 within delta.
    q, refs = make_dataset(k, 65, n, seed=3 * n + k)
    je, pe = _pair(refs, tile_m=32, tile_n=tile_n)
    m_j, i_j, c_j = je.query_min_idx_cert(q)
    m_p, i_p, c_p = pe.query_min_idx_cert(q)
    assert i_p.dtype == np.int32 and c_p.dtype == np.bool_
    np.testing.assert_array_equal(i_p, i_j)
    np.testing.assert_array_equal(c_p, c_j)
    assert np.abs(m_p - m_j).max() <= pe.stage_queries(q).delta
    np.testing.assert_array_equal(pe.query(q), je.query(q))


@pytest.mark.parametrize("case", range(6))
def test_nns_v9_equals_jax_on_grid(case, grid_datasets):
    # k = 3 rows route to v4, k = 16 rows run the expansion engine.
    k, m, n, q, r = grid_datasets[case]
    got = nns_tpu_torch.nns(q, r, version=9, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(nns_tpu.nns(q, r, version=9)))
    assert_exact(got, q, r)


@pytest.mark.parametrize("k,m,n", [(10, 33, 600), (16, 17, 1000), (5, 40, 777), (24, 20, 1500)])
def test_nns_v9_equals_jax_unaligned(k, m, n):
    q, r = make_dataset(k, m, n, seed=m + n)
    got = nns_tpu_torch.nns(q, r, version="mxu_expansion", device="cpu")
    np.testing.assert_array_equal(got, np.asarray(nns_tpu.nns(q, r, version=9)))
    assert_exact(got, q, r)


@pytest.mark.parametrize("k", [3, 16])
def test_engine_v9_query_many_equals_jax(k):
    q, r = make_dataset(k, 150, 3000, seed=21 + k)
    eng = nns_tpu_torch.NNEngine(9, device="cpu").build(r)
    jeng = nns_tpu.NNEngine(9).build(r)
    if k >= 8:
        assert isinstance(eng._built, P.MXUExpansion)
    else:
        assert isinstance(eng._built, torch.Tensor)  # the refs alone; v4 answers
    want = np.asarray(jeng.query(q))
    np.testing.assert_array_equal(eng.query(q), want)
    parts = eng.query_many([q[:40], q[40:41], q[41:]])
    assert [p.shape[0] for p in parts] == [40, 1, 109]
    np.testing.assert_array_equal(np.concatenate(parts), want)
    np.testing.assert_array_equal(
        np.concatenate(parts), np.concatenate(jeng.query_many([q[:40], q[40:41], q[41:]])))
    assert eng.query_many([]) == []


def test_engine_v9_past_staging_bound_degrades_to_fused(monkeypatch):
    def refuse(self, refs, **kw):
        raise ValueError("MXUExpansion supports n < 2^25 (device staging)")

    monkeypatch.setattr(P.MXUExpansion, "__init__", refuse)
    q, r = make_dataset(16, 30, 2000, seed=5)
    eng = nns_tpu_torch.NNEngine(9, device="cpu").build(r)
    assert isinstance(eng._built, FusedBruteForce)
    np.testing.assert_array_equal(eng.query(q), np.asarray(nns_tpu.nns(q, r, version=4)))


@pytest.mark.parametrize("k,expect", [(8, 9), (16, 9), (7, 4)])
def test_auto_picks_v9_at_high_k(k, expect):
    q, r = make_dataset(k, 20, 3000, seed=k)
    eng = nns_tpu_torch.NNEngine(device="cpu").build(r)
    assert eng.spec.num == expect
    np.testing.assert_array_equal(eng.query(q), np.asarray(nns_tpu.NNEngine().build(r).query(q)))


def test_v9_defers_the_high_k_probe():
    # The high-k probe waits for hk_probe_after queries over at least
    # hk_promote_n_min refs, then runs once, as the JAX engine's does
    # (nns_tpu/api.py:342-429): both engines land on the same rung and
    # answer alike before and after it (the ladder: test_torch_high_k.py).
    import nns_tpu.config
    from nns_tpu_torch.config import EngineConfig

    cfg = dict(hk_promote_n_min=1000, hk_probe_after=100)
    q, r = make_dataset(16, 60, 1500, seed=6)
    eng = nns_tpu_torch.NNEngine(9, config=EngineConfig(**cfg), device="cpu").build(r)
    jeng = nns_tpu.NNEngine(9, nns_tpu.config.EngineConfig(**cfg)).build(r)

    def rung(e):
        return type(e._built).__name__, e._hk_probed, e._hk_beam, e._hk_budget

    np.testing.assert_array_equal(eng.query(q), np.asarray(jeng.query(q)))
    assert not eng._hk_probed and isinstance(eng._built, P.MXUExpansion)
    for got, want in zip(eng.query_many([q, q]), jeng.query_many([q, q])):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert eng._hk_probed and rung(eng) == rung(jeng)
    assert eng._hk_mxu is None or isinstance(eng._hk_mxu, P.MXUExpansion)
    np.testing.assert_array_equal(eng.query(q), np.asarray(jeng.query(q)))
    assert_exact(eng.query(q), q, r)
    assert rung(eng) == rung(jeng)


def test_engine_from_jax_state_equals_built():
    q, refs = make_dataset(16, 50, 2500, seed=8)
    je = J.MXUExpansion(refs, tile_m=16, tile_n=512)
    state = {"refs": refs, "rc": np.asarray(je.rc), "r2h": np.asarray(je.r2h),
             "refs_t": np.asarray(je.refs_t), "r2h_t": np.asarray(je.r2h_t),
             "tile_n": je.tile_n, "ts": je.ts}
    conv = mxu_engine_from_numpy(state, device="cpu")
    built = P.MXUExpansion(refs, tile_n=512, device="cpu")
    np.testing.assert_array_equal(_bits(conv.rc), _bits(built.rc))
    for a, b in zip(conv.query_min_idx_cert(q), built.query_min_idx_cert(q)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(conv.query(q), np.asarray(je.query(q)))
    with pytest.raises(KeyError, match="lacks"):
        mxu_engine_from_numpy({"refs": refs}, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        mxu_engine_from_numpy({**state, "ts": 384}, device="cpu")


def test_cpu_path_launches_no_kernel():
    _cuda.reset_launches()
    q, r = make_dataset(16, 20, 900, seed=24)
    nns_tpu_torch.nns(q, r, version=9, device="cpu")
    assert set(_cuda.LAUNCHES.values()) == {0}


def test_module_imports_no_jax():
    code = ("import sys, nns_tpu_torch.kernels.mxu_expansion, nns_tpu_torch.convert; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'nns_tpu')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.stdout.strip() == "[]", out.stdout


# ---------------------------------------------------------------------------
# tests/test_mxu_expansion.py's cases whose mechanism the port keeps
# ---------------------------------------------------------------------------


def test_certified_answers_exact_across_tiles():
    rng = np.random.default_rng(3)
    refs = rng.random((1000, 16), dtype=np.float32)
    queries = rng.random((57, 16), dtype=np.float32)
    eng = P.MXUExpansion(refs, tile_n=128, device="cpu")  # 8 tiles, last padded
    min1, idx, cert = eng.query_min_idx_cert(queries)
    oracle = _oracle(queries, refs)
    assert cert.mean() > 0.9
    assert (idx[cert] == oracle[cert]).all()
    e_win = 0.5 * (refs[idx].astype(np.float64) ** 2).sum(1) - (
        queries.astype(np.float64) * refs[idx].astype(np.float64)).sum(1)
    np.testing.assert_allclose(min1, e_win, atol=1e-4)
    assert recall_at_1(eng.query(queries), queries, refs) == 1.0


@pytest.mark.parametrize("dup_pos", [5, 700])
def test_duplicates_fail_certificate_but_stay_exact(dup_pos):
    rng = np.random.default_rng(4)
    refs = rng.random((1000, 16), dtype=np.float32)
    refs[dup_pos] = refs[2]
    q = refs[2:3].copy()
    je, pe = _pair(refs)
    _, _, cert = pe.query_min_idx_cert(q)
    assert not cert[0], "exact duplicate must fail the certificate"
    assert int(pe.query(q)[0]) == int(np.asarray(je.query(q))[0]) == min(2, dup_pos)


def test_winner_in_last_padded_tile():
    rng = np.random.default_rng(5)
    refs = rng.random((130, 16), dtype=np.float32) + 4.0
    q = (refs[129] + 1e-3).reshape(1, -1).astype(np.float32)
    eng = P.MXUExpansion(refs, tile_n=128, device="cpu")
    _, idx, cert = eng.query_min_idx_cert(q)
    assert cert[0] and idx[0] == 129


def test_subtile_ids_ns_gt_1_exact():
    rng = np.random.default_rng(8)
    refs = rng.random((3000, 16), dtype=np.float32)
    queries = rng.random((65, 16), dtype=np.float32)
    je, pe = _pair(refs, tile_m=32, tile_n=1024)
    assert pe.ts == 256 and pe.tile_n // pe.ts == 4
    _, idx, cert = pe.query_min_idx_cert(queries)
    oracle = _oracle(queries, refs)
    assert cert.mean() > 0.9 and (idx[cert] == oracle[cert]).all()
    np.testing.assert_array_equal(pe.query(queries), je.query(queries))
    refs2 = refs.copy()
    refs2[700] = refs2[100]  # subtile 1 vs subtile 0 of tile 0
    eng2 = P.MXUExpansion(refs2, tile_n=1024, device="cpu")
    _, _, cert2 = eng2.query_min_idx_cert(refs2[100:101].copy())
    assert not cert2[0]
    assert int(eng2.query(refs2[100:101].copy())[0]) == 100


@pytest.mark.parametrize("g_rel", [0.0, 1e-7, 1e-6, 1e-5, 1e-3, 1e-1])
def test_certificate_boundary_near_ties(g_rel):
    """Runner-up gaps swept around the band: a certified row is never
    wrong, query() is exact, and far past the band the certificate holds."""
    rng = np.random.default_rng(12)
    k = 16
    refs = rng.random((500, k)).astype(np.float32) + 2.0
    q = np.zeros((1, k), dtype=np.float32)
    refs[7] = 0.0
    refs[7, 0] = 1.0
    refs[313] = 0.0
    refs[313, 0] = np.float32(np.sqrt(1.0 + 2.0 * g_rel))
    je, pe = _pair(refs)
    _, idx, cert = pe.query_min_idx_cert(q)
    d_true = ((refs[_oracle(q, refs)[0]].astype(np.float64)) ** 2).sum()
    if cert[0]:
        assert ((refs[idx[0]].astype(np.float64)) ** 2).sum() == d_true
    out = int(pe.query(q)[0])
    assert ((refs[out].astype(np.float64)) ** 2).sum() == d_true
    assert out == int(np.asarray(je.query(q))[0])
    if g_rel >= 1e-1:
        assert cert[0]


def test_empty_query_batch():
    refs = np.random.default_rng(9).random((300, 16), dtype=np.float32)
    eng = P.MXUExpansion(refs, tile_n=128, device="cpu")
    assert eng.query(np.zeros((0, 16), np.float32)).shape == (0,)
    min1, idx, cert = eng.query_min_idx_cert(np.zeros((0, 16), np.float32))
    assert min1.shape == idx.shape == cert.shape == (0,)
    assert nns_tpu_torch.NNEngine(9, device="cpu").build(refs).query_many(
        [np.zeros((0, 16), np.float32)])[0].shape == (0,)


def test_tile_n_not_multiple_of_ts_falls_back_to_per_tile_ids():
    rng = np.random.default_rng(10)
    refs = rng.random((2000, 16), dtype=np.float32)
    queries = rng.random((40, 16), dtype=np.float32)
    je, pe = _pair(refs, tile_m=16, tile_n=640)
    assert pe.ts == 640
    np.testing.assert_array_equal(pe.query(queries), je.query(queries))


def test_large_query_count_chunks():
    # At tile_n = ts = 512 the phase-2 chunk is 4096 rows: 4100 rows run 2.
    rng = np.random.default_rng(7)
    refs = rng.random((1024, 16), dtype=np.float32)
    queries = rng.random((4100, 16), dtype=np.float32)
    eng = P.MXUExpansion(refs, tile_n=512, device="cpu")
    assert recall_at_1(eng.query(queries), queries, refs) == 1.0


def _count_full_scans(monkeypatch):
    calls = []
    real = P._full_scan_rows

    def spy(qb, *a):
        calls.append(qb.shape[0])
        return real(qb, *a)

    monkeypatch.setattr(P, "_full_scan_rows", spy)
    return calls


def test_band_refine_certifies_near_ties_without_full_scan(monkeypatch):
    rng = np.random.default_rng(21)
    refs = (rng.random((2000, 16)) + 2.0).astype(np.float32)
    q = refs[50].astype(np.float64)
    refs[900] = (q + 3e-6).astype(np.float32)
    q = (q + 1.5e-6).astype(np.float32).reshape(1, -1)
    je, pe = _pair(refs, tile_n=512)
    _, _, cert = pe.query_min_idx_cert(q)
    assert not cert[0]
    calls = _count_full_scans(monkeypatch)
    out = pe.query(q)
    d50 = ((q[0].astype(np.float64) - refs[50]) ** 2).sum()
    d900 = ((q[0].astype(np.float64) - refs[900]) ** 2).sum()
    assert int(out[0]) == (50 if d50 <= d900 else 900) == int(np.asarray(je.query(q))[0])
    assert calls == [], "tier 1 resolves it"


def test_band_refine_two_tile_duplicate_resolved_by_tier1(monkeypatch):
    rng = np.random.default_rng(22)
    refs = (rng.random((2000, 16)) + 2.0).astype(np.float32)
    refs[1600] = refs[30]
    q = refs[30:31].copy()
    pe = P.MXUExpansion(refs, tile_n=512, device="cpu")
    assert not pe.query_min_idx_cert(q)[2][0]
    calls = _count_full_scans(monkeypatch)
    assert int(pe.query(q)[0]) == 30
    assert calls == []


def test_band_refine_three_tile_tie_resolved_by_full_scan(monkeypatch):
    rng = np.random.default_rng(23)
    refs = (rng.random((2000, 16)) + 2.0).astype(np.float32)
    refs[1100] = refs[30]
    refs[1600] = refs[30]
    q = refs[30:31].copy()
    pe = P.MXUExpansion(refs, tile_n=512, device="cpu")
    assert not pe.query_min_idx_cert(q)[2][0]
    calls = _count_full_scans(monkeypatch)
    assert int(pe.query(q)[0]) == 30
    assert calls == [1]


def test_duplicate_flood_stays_exact():
    # 512 exact-duplicate rows: every row fails the certificate; the port
    # has no bucket to overflow and answers all at the lowest index.
    rng = np.random.default_rng(41)
    refs = (rng.random((1000, 16)) + 1.0).astype(np.float32)
    refs[700] = refs[30]
    q = np.repeat(refs[30:31], 512, axis=0).astype(np.float32)
    je, pe = _pair(refs)
    out = pe.query(q)
    assert (out == 30).all()
    np.testing.assert_array_equal(out, np.asarray(je.query(q)))


def test_three_tile_flood_equals_jax():
    # 96 three-tile exact duplicates: the band refine refuses every row and
    # the full scan answers each at the lowest index.
    rng = np.random.default_rng(29)
    refs = (rng.random((2000, 16)) + 2.0).astype(np.float32)
    for i in range(96):
        refs[600 + i] = refs[i]
        refs[1700 + i] = refs[i]
    q = refs[:96].copy()
    je, pe = _pair(refs, tile_n=512)
    out = pe.query(q)
    np.testing.assert_array_equal(out, np.arange(96, dtype=np.int32))
    np.testing.assert_array_equal(out, np.asarray(je.query(q)))
