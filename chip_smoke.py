"""Smoke test of the PyTorch/CUDA port (nns_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, nvcc and g++, and exits non-zero (printing no
result) without them. Phases, each raising on failure:

0. the card's name and power limit (nvidia-smi);
1. build every CUDA kernel (one nvcc per source, all started together) and
   the native host library from the sources, and time one nvcc call over
   the same sources for comparison;
2. the v14 and v4 kernels against their plain PyTorch versions on the
   card, at the main path's shapes: indices equal and min_d2 bit-equal (tolerance 0: both
   round every sub, mul and add to nearest, no FMA), times from CUDA events
   (median of 5). The scan runs its Hopper design (persistent blocks, each
   group's distinct slots scored once, the halo through a two-stage ring of
   bulk asynchronous copies) on one uniform 10K batch and on a skewed one
   (QM >= 512);
3. the main path: ``NNEngine("cells", device="cuda").build`` over 1M uniform
   3-D refs (seed 1000) and ``query_many`` over W=64 distinct 10K-query
   batches drawn as bench.py draws them, plus one batch drawn over
   (-0.5, 1.5)^3 whose uncertified rows go through the fused fallback. Both
   kernels' launch counts must grow during that query_many, and three f64
   oracle gates (batch 0, a random mid-queue batch, all fallback rows; up
   to 512 queries each) must read recall 1.0;
4. the one-shot ``nns(version=4)`` and ``nns(version="cells")`` at 1M x 10K;
5. the ladder's kernels (v3 point-major, v5 streaming, v6 queries-resident,
   v7 two-level) against their plain versions at 10000 x 1M k=3, 1024 x 1M
   k=3, 1024 x 1M k=16, duplicate ties and an unaligned 33 x 777 k=5, v5
   at 1024 x 65536 k=128 (where a whole-k stage once outgrew shared
   memory), v7 at 64 x 65536 k=4096 (where its whole-k query tile once
   did), and v6 and v7 on rows whose every distance overflows to +inf
   (+-3e19; 1024 x 1M k=3 and 256 x 65536 k=5), which must answer index
   0, with the same tolerance 0 and timing as phase 2. v7 runs v5's ring,
   its walk cut at the table's tile boundaries (one winner per tile and
   row, then the second reduce). v6 runs its
   Hopper design: each thread's query rows in registers (k = 3 and 16 as
   template parameters; k = 5 at run time, the contraction in slices of at
   most 16 dims), the refs through a two-stage ring of bulk asynchronous
   copies, one walk of each ref range per 1024 rows. v3 and v5 run theirs:
   query tiles of 256 or 1024 rows held in registers (4 rows per thread at
   k = 3 and 16), the refs through a 4-stage producer/consumer ring (one
   producer warp issues the bulk copies, full and empty mbarriers per
   stage, no block-wide barrier in the loop): v5 one copy per dimension row
   of a dim-major tile (in slices of at most 16 dims at a run-time k), v3
   one copy per stage of whole points in the caller's (n, k) layout, the
   last 0-3 floats loaded by hand so that nothing past row n is read; below
   256 rows (the 64-row ties case) threads share each row and split its
   columns;
6. the ladder: ``nns(version=v)`` for v = 0..7 and 9 at 1024 x 1M, k = 3
   and 16. Each answer passes the f64 gate on a 512-row subsample; v1, v3,
   v4, v5, v6, v7 and v9 return equal index arrays; v0 (host scan) and v2
   (expansion matmul) print how many indices they share with v4; each
   ladder kernel's launch count, zeroed just before its version's call,
   must grow during it (v9: ``fused_argmin`` at k = 3, ``expansion_phase1``
   at k = 16); and v6 under a query budget below m * k * 4 must launch the
   v4 kernel instead;
7. v9's phase-1 kernels against ``phase1_plain``: the wgmma kernel, the
   route at every kp, at 10000 x 1M and 1024 x 1M k=16, unaligned 33 x 777
   at k=16, 10 and 24, 1024 x 1M k=24 (blocks padded to 32 dims) and 1024 x
   65536 k=128 (dimension slices, the query tile resident), plus the
   mma.sync kernel, no route any more, through its own entry point at
   10000 x 1M k=16, 1024 x 1M k=24 and 1024 x 65536 k=128 as the
   yardstick: values within the engine's delta, ids equal wherever the
   plain runner-up is more than 2 delta away (tensor cores sum in their own
   order, so no bit equality); and 64 x 1M integer-valued k=16 refs with
   exact duplicates, where every sum is exact and all six outputs must be
   equal. Then ``nns(version=9)`` at 1024 x 65536 k=128, the path that
   runs phase 1 past a resident kp, with the launch counts zeroed just
   before: it must launch the wgmma kernel and answer as the v4 kernel;
8. the v9 main path: ``NNEngine(9, device="cuda").build`` over the 1M 16-D
   refs (seed 1000) and ``query_many`` over W=64 distinct 10K batches. The
   ``expansion_phase1_wgmma`` count must grow; the drain's own phase-1
   launch (all 640K rows at once) is held against ``phase1_plain`` in
   10K-row chunks with the same tolerance, and so is the mma.sync kernel on
   the same launch (timed beside it); all 640K answers must equal the v4
   kernel's; batch 0 passes the f64 gate on the ladder's 512-row oracle and
   up to 128 uncertified rows pass a float64 scan on the card; the rows of
   each v3 full scan the drain runs are printed;
9. one JSON line of per-kernel results, each row with the shape its ms,
   plain_ms and bound come from (the scan also on the skewed batch,
   ``*_skewed``; the ladder's kernels and v4 also at 1024 x 1M k=16,
   ``*_k16``): each kernel's main path (for the wgmma kernel's row the
   drain's 640K-row launch; for the ``expansion_phase1`` row, phase 1 at
   the padded and sliced kp, v9 at 1024 x 65536 k=128 and 1024 x 1M k=24
   (``*_k24``), with the mma.sync kernel's times on the same inputs and on
   the drain's launch as ``yardstick``s), then the device line last. ``ms`` brackets each wrapper
   call with CUDA events, so a launch shorter than its wrapper's host time
   reads the host time; the scan's and v4's rows, whose launches are that
   short, also give ``device_ms`` (``utils/timing.cuda_device_ms``: the
   device held busy while the calls are enqueued).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 1000
N_REFS = 1_000_000
N_QUERIES = 10_000
W = 64
K = 3
GATE_ROWS = 512
K16 = 16


def _log(msg: str) -> None:
    print(msg, flush=True)


def _compare(name, kernel_fn, plain_fn, args, expect_idx=None):
    """Kernel vs plain on the same card tensors: indices equal, min_d2
    bit-equal. Returns (max_abs_err, kernel_ms, plain_ms)."""
    from nns_tpu_torch.utils.timing import cuda_ms

    k_ms, (kd, ki) = cuda_ms(kernel_fn, *args)
    p_ms, (pd, pi) = cuda_ms(plain_fn, *args)
    if not torch.equal(ki, pi):
        bad = int((ki != pi).sum())
        raise AssertionError(f"{name}: {bad} indices differ between kernel and plain")
    if not torch.equal(kd, pd):
        raise AssertionError(f"{name}: min_d2 not bit-equal between kernel and plain")
    if expect_idx is not None:
        expect_idx(ki)
    fin = torch.isfinite(pd)  # inf on rows whose every distance overflows
    err = float((kd[fin].double() - pd[fin].double()).abs().max()) if fin.any() else 0.0
    _log(f"[kernel] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
         f"indices equal, max_abs_err {err}")
    return err, k_ms, p_ms


def _phase1_check(name, kern, plain, delta, exact=False):
    """expansion_phase1's outputs against phase1_plain's for the same
    inputs: values within delta and ids equal where the plain runner-up is
    more than 2 delta away, or (``exact``) all six outputs equal. Returns
    (max_abs_err, log text)."""
    k1, kt, km2, kt2v, kid2, kt3 = kern
    p1, pt, pm2, pt2v, pid2, pt3 = plain
    err = 0.0
    for kv, pv in ((k1, p1), (km2, pm2), (kt2v, pt2v), (kt3, pt3)):
        fin = torch.isfinite(pv)
        if not torch.equal(torch.isfinite(kv), fin):
            raise AssertionError(f"{name}: kernel and plain differ in which values are inf")
        if fin.any():
            err = max(err, float((kv[fin].double() - pv[fin].double()).abs().max()))
    if exact:
        for what, a, b in zip(("min1", "tid", "m2x", "t2v", "tid2", "t3v"), kern, plain):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: {what} differs on exact data")
    if err > delta:
        raise AssertionError(f"{name}: values differ by {err / delta} delta")
    sep = (pm2 - p1) > 2 * delta
    sep2 = ((pt2v - p1) > 2 * delta) & ((pt3 - pt2v) > 2 * delta)
    for what, a, b, rows in (("tid", kt, pt, sep), ("tid2", kid2, pid2, sep2)):
        if not torch.equal(a[rows], b[rows]):
            raise AssertionError(f"{name}: {int((a[rows] != b[rows]).sum())} {what} differ "
                                 "on rows separated by more than 2 delta")
    return err, (f"max |value diff| {err} = {err / delta:.4f} delta (delta {delta:.4e}); "
                 f"tid equal on {int(sep.sum())}/{len(sep)} separated rows, "
                 f"tid2 on {int(sep2.sum())}")


def _phase1_compare(name, args, rc_t, delta, exact=False, route=None, plain=None):
    """Phase 1 on the card (the kernel phase1 dispatches to, or ``route``'s
    through its own entry point, which needs a contiguous rc in ``args``)
    against phase1_plain on the same card tensors (``_phase1_check``), each
    timed; ``plain`` = (plain_ms, outputs) when already computed. Returns
    (launch key of the kernel that ran, (max_abs_err, kernel_ms, plain_ms),
    plain)."""
    from nns_tpu_torch.kernels import _cuda
    from nns_tpu_torch.kernels.mxu_expansion import _phase1_cuda, phase1, phase1_plain
    from nns_tpu_torch.utils.timing import cuda_ms

    before = _cuda.LAUNCHES["expansion_phase1_wgmma"]
    if route is None:
        k_ms, kern = cuda_ms(lambda: phase1(*args, rc_t=rc_t))
    else:
        k_ms, kern = cuda_ms(lambda: _phase1_cuda(*args, rc_t, route))
    key = ("expansion_phase1_wgmma" if _cuda.LAUNCHES["expansion_phase1_wgmma"] > before
           else "expansion_phase1")
    plain = cuda_ms(phase1_plain, *args) if plain is None else plain
    err, text = _phase1_check(name, kern, plain[1], delta, exact)
    _log(f"[kernel] {name} ({key}): kernel {k_ms:.4f} ms, plain {plain[0]:.4f} ms, {text}")
    return key, (err, k_ms, plain[0]), plain


def _oracle_f64_card(queries, refs, dev):
    """(idx, min d2) of each query by a chunked float64 torch scan on the
    card, independent of every kernel of the port: the f64 expansion ranks
    (its rounding, ~1e-15 relative, sits far inside recall_at_1's 1e-9
    band), and the winner's distance is taken directly in f64."""
    r = torch.as_tensor(refs, device=dev).double()
    r2 = (r * r).sum(dim=1)
    idx, dmin = [], []
    for lo in range(0, len(queries), 16):
        q = torch.as_tensor(queries[lo:lo + 16], device=dev).double()
        i = ((q * q).sum(dim=1, keepdim=True) - 2.0 * q @ r.t() + r2).argmin(dim=1)
        idx.append(i.cpu().numpy())
        dmin.append(((q - r[i]) ** 2).sum(dim=1).cpu().numpy())
    return np.concatenate(idx), np.concatenate(dmin)


def _gate(name, idx, queries, refs, oracle_dmin=None) -> float:
    from nns_tpu_torch.kernels.oracle import recall_at_1

    rec = recall_at_1(idx, queries, refs, oracle_dmin)
    _log(f"[gate] {name}: recall@1 {rec} over {len(idx)} f64-oracle queries")
    if rec != 1.0:
        raise AssertionError(f"{name}: recall@1 {rec} != 1.0")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from nns_tpu_torch import NNEngine, nns
    from nns_tpu_torch.config import EngineConfig
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import _cuda, fused_ladder as fl
    from nns_tpu_torch.kernels.cell_list import CellListEngine, cell_scan, cell_scan_plain
    from nns_tpu_torch.kernels.fused import fused_min_idx, fused_min_idx_plain, prepare_refs
    from nns_tpu_torch.kernels import mxu_expansion as mxe
    from nns_tpu_torch.kernels.mxu_expansion import (
        MXUExpansion, _cat_q, phase1, phase1_plain, split_bf16x3)
    from nns_tpu_torch.kernels.oracle import nn_oracle_f64
    from nns_tpu_torch.native import native_available
    from nns_tpu_torch.utils.bounds import cell_bound, fused_bound, phase1_bound
    from nns_tpu_torch.utils.timing import cuda_device_ms, cuda_ms

    LADDER_KERNELS = (  # (launch key, wrapper, plain twin, point-major refs)
        ("fused_point_major", fl.fused_point_major_min_idx, fl.fused_point_major_plain, True),
        ("fused_streaming", fl.fused_streaming_min_idx, fl.fused_streaming_plain, False),
        ("fused_queries_resident", fl.fused_queries_resident_min_idx,
         fl.fused_queries_resident_plain, False),
        ("two_level", fl.two_level_min_idx, fl.two_level_plain, False),
    )
    VERSION_KERNEL = {3: "fused_point_major", 5: "fused_streaming",
                      6: "fused_queries_resident", 7: "two_level"}
    LADDER_VERSIONS = [v for v in range(10) if v != 8]  # v8 is multi-device

    # 0. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    _log(f"[device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    # 1. Build.
    t0 = time.perf_counter()
    _cuda.build(force=True)
    _cuda.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native_available():
        raise RuntimeError("native host library did not build (g++ -fopenmp)")
    native_s = time.perf_counter() - t0
    # The same sources in one nvcc call, for comparison with the build's one
    # nvcc per source.
    with tempfile.TemporaryDirectory(dir=_cuda._BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", *_cuda._sources(),
                        "-o", os.path.join(tmp, "one_call.so")],
                       check=True, capture_output=True, timeout=600)
        one_call_s = time.perf_counter() - t0
    _log(f"[build] CUDA kernels {build_s:.2f} s, one nvcc per source and a link "
         f"(nvcc {' '.join(_cuda.NVCC_FLAGS)}); the same sources in one nvcc call "
         f"{one_call_s:.2f} s; native host library {native_s:.2f} s")

    # 2. Kernels against their plain versions.
    queries, refs = make_dataset(K, N_QUERIES, N_REFS, SEED)
    results = {"fused_argmin": [], "cell_scan": []}  # + the ladder's, phase 5

    r_dm, _ = prepare_refs(refs, 4096, dev)
    q_dev = torch.as_tensor(queries, device=dev)
    q16, r16 = make_dataset(16, 1024, 65536, SEED)
    r16_dm, _ = prepare_refs(r16, 4096, dev)
    ties = refs.copy()
    target = np.array([0.5, 0.5, 0.5], np.float32)
    for i in (11, 400_000, 999_999):
        ties[i] = target
    q_ties = np.concatenate([np.repeat(target[None], 5, 0), queries[:59]]).astype(np.float32)
    ties_dm, _ = prepare_refs(ties, 4096, dev)

    def _ties_ok(idx):
        if not bool((idx[:5] == 11).all()):
            raise AssertionError(f"duplicate ties: expected index 11, got {idx[:5].tolist()}")

    fused_cases = [
        ("fused 8 x 1M k=3 (fallback bucket)", (q_dev[:8], r_dm, N_REFS), None),
        ("fused 10000 x 1M k=3", (q_dev, r_dm, N_REFS), None),
        ("fused 1024 x 65536 k=16", (torch.as_tensor(q16, device=dev), r16_dm, 65536), None),
        ("fused 64 x 1M duplicate ties", (torch.as_tensor(q_ties, device=dev), ties_dm, N_REFS),
         _ties_ok),
    ]
    for name, args, expect in fused_cases:
        results["fused_argmin"].append(
            _compare(name, fused_min_idx, fused_min_idx_plain, args, expect))
    # The two main rows whose launches are shorter than their wrappers' host
    # time also get the device time alone, beside ``ms``.
    device_ms = {"fused_argmin": cuda_device_ms(fused_min_idx, *fused_cases[0][1])[0]}

    cells = CellListEngine(refs, device=dev)
    _log(f"[kernel] 1M index: D={cells.D}, G={cells.D ** 3}, R_max={cells.R_max}, "
         f"halo={cells.halo:.4f}, avg candidates {cells.avg_candidates:.0f}")
    skew = queries.copy()
    skew[:600] = (np.float32(0.51) + np.random.default_rng(SEED).random(
        (600, 3), dtype=np.float32) * np.float32(0.01))
    cell_bounds = []  # the one 10K batch's, then the skewed batch's
    for name, qb in (("cell_scan one 10K batch", queries), ("cell_scan skewed 10K batch", skew)):
        packed, _, q_max = cells.stage(qb)
        dense, _ = cells._dense_scatter(packed, q_max)
        args = (torch.as_tensor(dense, device=dev), cells.halo_dm, cells.halo_ids_dev, cells.halo2)
        results["cell_scan"].append(
            _compare(f"{name} (G={dense.shape[0]}, QM={dense.shape[1]}, R_max={cells.R_max})",
                     cell_scan, cell_scan_plain, args))
        device_ms.setdefault("cell_scan", cuda_device_ms(cell_scan, *args)[0])
        cell_bounds.append(cell_bound(*dense.shape[:2], cells.R_max, len(qb),
                                      cells.avg_candidates))
    skew_qm = cells.stage(skew)[2]
    if skew_qm < 512:
        raise AssertionError("the skewed batch did not reach QM >= 512")
    del cells

    # 3. The main path.
    engine = NNEngine("cells", device="cuda")
    t0 = time.perf_counter()
    engine.build(refs)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    if not isinstance(engine._built, CellListEngine):
        raise AssertionError(f"NNEngine('cells') built {type(engine._built).__name__}")
    rng = np.random.default_rng(SEED + 1)
    lo, hi = refs.min(axis=0), refs.max(axis=0)
    batches = [queries] + [
        (rng.random((N_QUERIES, K), dtype=np.float32) * (hi - lo) + lo).astype(np.float32)
        for _ in range(W - 1)
    ]
    ood = (rng.random((N_QUERIES, K), dtype=np.float32) * 2.0 - 0.5).astype(np.float32)
    queue = batches + [ood]

    _cuda.reset_launches()
    t0 = time.perf_counter()
    served = engine.query_many(queue)
    queue_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    _log(f"[main] launches during query_many: {launches}")
    for name in ("cell_scan", "fused_argmin"):  # the ladder's kernels: phase 6
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched by the main path")

    cell = engine._built
    flags = [cell.query_with_flags(b)[1] for b in queue]
    n_cert = int(sum(int(f.sum()) for f in flags))
    n_rows = len(queue) * N_QUERIES
    _log(f"[main] build {build_ms:.1f} ms (D={cell.D}, R_max={cell.R_max}); "
         f"query_many over {len(queue)} batches {queue_s * 1e3 / len(queue):.3f} ms/batch "
         f"(first call); certified {n_cert}/{n_rows} "
         f"({int(sum(int(f.sum()) for f in flags[:W]))}/{W * N_QUERIES} uniform, "
         f"{int(flags[W].sum())}/{N_QUERIES} out-of-box); "
         f"promotions deferred {engine.promotions_deferred}")

    sub = np.random.default_rng(0).choice(N_QUERIES, GATE_ROWS, replace=False)
    _gate("batch 0 (512 subsample)", served[0][sub], queries[sub], refs)
    rb = int(np.random.default_rng(1).integers(1, W))
    sub_rb = np.random.default_rng(2).choice(N_QUERIES, GATE_ROWS, replace=False)
    _gate(f"batch {rb} (512 subsample)", served[rb][sub_rb], queue[rb][sub_rb], refs)
    fb_q = np.concatenate([b[~f] for b, f in zip(queue, flags)])
    fb_idx = np.concatenate([s[~f] for s, f in zip(served, flags)])
    nchk = min(GATE_ROWS, len(fb_q))
    sub_fb = np.random.default_rng(3).choice(len(fb_q), nchk, replace=False)
    _gate(f"fallback rows ({nchk} of {len(fb_q)})", fb_idx[sub_fb], fb_q[sub_fb], refs)

    for s, qb in zip(served, queue):
        if s.shape != (qb.shape[0],) or s.min() < 0 or s.max() >= N_REFS:
            raise AssertionError("query_many returned out-of-range indices")

    t0 = time.perf_counter()
    engine.query_many(batches)
    drain_ms = (time.perf_counter() - t0) * 1e3 / W
    denses, _, _ = cell.stage_queue_ragged(batches)
    dq = [torch.as_tensor(d, device=dev) for d in denses]
    scan_ms, _ = cuda_ms(cell.query_queue_staged, dq, iters=5)
    torch.cuda.reset_peak_memory_stats()
    engine.query_many(batches[:8])
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    _log(f"[main] uniform drain W={W}: {drain_ms:.3f} ms/batch end to end "
         f"(host staging + upload + scans + one download + unscatter); "
         f"device scans alone {scan_ms / W:.4f} ms/batch (CUDA events, median of 5); "
         f"device memory peak {peak_mb:.0f} MiB")

    # 4. One-shot entry points.
    for version in (4, "cells"):
        t0 = time.perf_counter()
        idx = nns(queries, refs, version=version, device="cuda")
        ms = (time.perf_counter() - t0) * 1e3
        _log(f"[nns] version={version!r}: {ms:.1f} ms one-shot (build included)")
        _gate(f"nns(version={version!r}) (512 subsample)", idx[sub], queries[sub], refs)

    # 5. The ladder's kernels against their plain versions.
    del engine, cell, served, dq
    q1k = q_dev[:1024]
    # bench_k16's workload on 1M refs: the ladder's 1024 queries are the
    # first 1024 of the main path's 10K batch 0 (make_dataset draws the refs
    # first, then the query rows in order).
    q16_10k, r16_1m = make_dataset(K16, N_QUERIES, N_REFS, SEED)
    q16_1m = q16_10k[:1024]
    q16_dev = torch.as_tensor(q16_1m, device=dev)
    r16_dm, _ = prepare_refs(r16_1m, 4096, dev)
    qu, ru = make_dataset(5, 33, 777, SEED)
    qu_dev = torch.as_tensor(qu, device=dev)
    ru_dm, _ = prepare_refs(ru, 4096, dev)
    ladder_cases = [  # (name, queries, dim-major refs, point-major refs, n, expect)
        ("10000 x 1M k=3", q_dev, r_dm, torch.as_tensor(refs, device=dev), N_REFS, None),
        ("1024 x 1M k=3", q1k, r_dm, torch.as_tensor(refs, device=dev), N_REFS, None),
        ("1024 x 1M k=16", q16_dev, r16_dm, torch.as_tensor(r16_1m, device=dev), N_REFS,
         None),
        ("64 x 1M duplicate ties", torch.as_tensor(q_ties, device=dev), ties_dm,
         torch.as_tensor(ties, device=dev), N_REFS, _ties_ok),
        ("33 x 777 k=5 unaligned", qu_dev, ru_dm, torch.as_tensor(ru, device=dev), 777, None),
    ]
    # v4 at the same shapes, so that the rungs compare within one call (its
    # rows go after the fallback bucket's, which stays the JSON's row).
    k16_row = {}  # each kernel's row of the 1024 x 1M k=16 case
    for name, kernel_fn, plain_fn, pm in (*LADDER_KERNELS,
                                          ("fused_argmin", fused_min_idx, fused_min_idx_plain, False)):
        results.setdefault(name, [])
        k16_row[name] = len(results[name]) + 2
        for case, qc, rc_dm, rc_pm, n, expect in ladder_cases:
            results[name].append(_compare(f"{name} {case}", kernel_fn, plain_fn,
                                          (qc, rc_pm if pm else rc_dm, n), expect))
    del ladder_cases
    # v5 where a whole-k stage outgrew the opt-in shared memory (k >= 56):
    # the sliced instance, 16 dims per stage.
    q128s, r128s = make_dataset(128, 1024, 65536, SEED)
    results["fused_streaming"].append(_compare(
        "fused_streaming 1024 x 65536 k=128 (sliced)", fl.fused_streaming_min_idx,
        fl.fused_streaming_plain,
        (torch.as_tensor(q128s, device=dev), prepare_refs(r128s, 4096, dev)[0], 65536)))
    del q128s, r128s
    # v7 at a k whose whole-k query tile once outgrew the opt-in shared
    # memory (from k = 3633): the sliced instance, 256 slices of 16 dims.
    q4k, r4k = make_dataset(4096, 64, 65536, SEED)
    results["two_level"].append(_compare(
        "two_level 64 x 65536 k=4096 (sliced)", fl.two_level_min_idx, fl.two_level_plain,
        (torch.as_tensor(q4k, device=dev), prepare_refs(r4k, 4096, dev)[0], 65536)))
    del q4k, r4k
    # Rows whose every distance overflows to +inf (coordinates of +-3e19):
    # v6 and v7 must answer the lowest index, 0, as the plain versions do.
    for k_o, m_o, n_o in ((3, 1024, N_REFS), (5, 256, 65536)):
        rng_o = np.random.default_rng(SEED + 3 + k_o)
        r_o = rng_o.random((n_o, k_o), dtype=np.float32)
        r_o[: n_o // 2, 0] = -3e19
        q_o = rng_o.random((m_o, k_o), dtype=np.float32)
        q_o[::2, 0] = 3e19
        r_o_dm, _ = prepare_refs(r_o, 4096, dev)

        def _overflow_ok(idx, n_o=n_o):
            if not bool((idx[::2] == 0).all()) or not bool((idx[1::2] >= n_o // 2).all()):
                raise AssertionError("overflowing rows: expected index 0 on every even row")

        for name, kernel_fn, plain_fn in (
                ("fused_queries_resident", fl.fused_queries_resident_min_idx,
                 fl.fused_queries_resident_plain),
                ("two_level", fl.two_level_min_idx, fl.two_level_plain)):
            results[name].append(_compare(
                f"{name} {m_o} x {n_o} k={k_o} +-3e19 (all-inf rows)", kernel_fn, plain_fn,
                (torch.as_tensor(q_o, device=dev), r_o_dm, n_o), _overflow_ok))
        del r_o, r_o_dm

    # 6. The ladder through the public entry point.
    ladder_launches = {name: 0 for name, *_ in LADDER_KERNELS}
    for k in (3, 16):
        qk, rk = (queries[:1024], refs) if k == 3 else (q16_1m, r16_1m)
        sub_k = np.random.default_rng(4).choice(1024, GATE_ROWS, replace=False)
        t0 = time.perf_counter()
        _, dmin = nn_oracle_f64(qk[sub_k], rk)
        _log(f"[ladder] k={k}: f64 oracle of {GATE_ROWS} rows over 1M refs "
             f"{time.perf_counter() - t0:.1f} s (host)")
        # v9 routes k < 8 to the v4 kernel and runs its own kernel above.
        VERSION_KERNEL[9] = "fused_argmin" if k < 8 else "expansion_phase1"
        answers = {}
        for version in LADDER_VERSIONS:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            answers[version] = idx = nns(qk, rk, version=version, device="cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {name: c for name, c in _cuda.LAUNCHES.items() if c}
            _log(f"[ladder] k={k} v{version}: {ms:.1f} ms one-shot (upload included), "
                 f"launches {counts}")
            own = VERSION_KERNEL.get(version)
            if own is not None:
                if _cuda.LAUNCHES[own] < 1:
                    raise AssertionError(f"nns(version={version}) did not launch {own}")
                if own in ladder_launches:
                    ladder_launches[own] += _cuda.LAUNCHES[own]
            if idx.shape != (1024,) or idx.min() < 0 or idx.max() >= N_REFS:
                raise AssertionError(f"v{version} returned out-of-range indices")
            _gate(f"k={k} v{version} (512 subsample)", idx[sub_k], qk[sub_k], rk, dmin)
        for version in (1, 3, 5, 6, 7, 9):
            if not np.array_equal(answers[version], answers[4]):
                bad = int((answers[version] != answers[4]).sum())
                raise AssertionError(f"k={k}: v{version} differs from v4 in {bad} indices")
        if k == 16:
            oracle16 = (sub_k, dmin)
        _log(f"[ladder] k={k}: v1, v3, v4, v5, v6, v7, v9 index arrays equal; "
             f"v0 shares {int((answers[0] == answers[4]).sum())}/1024 with v4, "
             f"v2 shares {int((answers[2] == answers[4]).sum())}/1024")
        _cuda.reset_launches()
        budget = EngineConfig(vmem_query_budget_bytes=1024 * k * 4 - 1)
        idx = nns(qk, rk, version=6, config=budget, device="cuda")
        if _cuda.LAUNCHES["fused_argmin"] < 1 or _cuda.LAUNCHES["fused_queries_resident"]:
            raise AssertionError(f"v6 over its budget launched {dict(_cuda.LAUNCHES)}")
        if not np.array_equal(idx, answers[4]):
            raise AssertionError("v6 over its budget differs from v4")
        _log(f"[ladder] k={k}: v6 with a {budget.vmem_query_budget_bytes}-byte budget "
             f"launched fused_argmin, not fused_queries_resident; answers equal v4")

    # 7. Both phase-1 kernels against their plain version.
    mx16 = MXUExpansion(r16_1m, device=dev)
    q16_dev10k = torch.as_tensor(q16_10k, device=dev)
    results["expansion_phase1"], results["expansion_phase1_wgmma"] = [], []

    def _phase1_case(name, eng, q, row_key, exact=False, yardstick=False):
        # The dispatched kernel (always the wgmma kernel), and with
        # ``yardstick`` the mma.sync kernel through its own entry point,
        # against one plain run. The dispatched row goes to results[row_key]
        # (the wgmma kernel's own row at kp % 16 == 0 up to 80 with the
        # query tile resident, else the padded and sliced shapes' row),
        # the yardstick's to the padded and sliced row. Returns the
        # dispatched kernel's (max_abs_err, kernel_ms, plain_ms).
        st = eng.stage_queries(q)
        args = (_cat_q(*split_bf16x3(st.q_dev)), eng.rc, eng.r2h, eng.tile_n, eng.ts)
        key, row, plain = _phase1_compare(f"phase 1 {name}", args, eng.rc_t, st.delta, exact)
        if key != WG:
            raise AssertionError(f"phase 1 {name}: {key} ran, {WG} expected")
        results[row_key].append(row)
        if yardstick:
            args = (args[0], eng.rc.contiguous(), *args[2:])
            _, y_row, _ = _phase1_compare(f"phase 1 {name} (mma.sync yardstick)", args, None,
                                          st.delta, exact, "mma_sync", plain)
            results[P1B].append(y_row)
            yardsticks[name] = y_row
        return row

    # WG: the wgmma kernel's row (the drain's launch); P1B: phase 1 at the
    # padded and sliced kp (the k = 128 path), with the mma.sync yardstick.
    WG, P1B = "expansion_phase1_wgmma", "expansion_phase1"
    yardsticks = {}
    _phase1_case("10000 x 1M k=16", mx16, q16_10k, WG, yardstick=True)
    _phase1_case("1024 x 1M k=16", mx16, q16_1m, WG)
    rng_int = np.random.default_rng(SEED + 2)
    r_int = rng_int.integers(0, 4, (N_REFS, K16)).astype(np.float32)
    q_int = rng_int.integers(0, 4, (64, K16)).astype(np.float32)
    for i, j in enumerate((0, 300_000, 999_999, 512_345)):  # ties across ref ranges
        r_int[j] = q_int[i]
        r_int[(j + 500_000) % N_REFS] = q_int[i]
    mx_int = MXUExpansion(r_int, device=dev)
    _phase1_case("64 x 1M k=16 integer duplicate ties (exact)", mx_int, q_int, WG, exact=True)
    del mx_int, r_int
    for k_u, key in ((16, WG), (10, WG), (24, P1B)):
        q_u, r_u = make_dataset(k_u, 33, 777, SEED)
        _phase1_case(f"33 x 777 k={k_u} unaligned", MXUExpansion(r_u, device=dev), q_u, key)
    q24, r24 = make_dataset(24, 1024, N_REFS, SEED)
    p1b_k24 = _phase1_case("1024 x 1M k=24 (blocks padded to 32 dims)",
                           MXUExpansion(r24, device=dev), q24, P1B, yardstick=True)
    del q24, r24
    q128, r128 = make_dataset(128, 1024, 65536, SEED)
    p1b_row = _phase1_case("1024 x 65536 k=128 (dimension slices)",
                           MXUExpansion(r128, device=dev), q128, P1B, yardstick=True)
    # The path that runs phase 1 at a kp past a resident query tile: v9 at
    # k = 128, now on the wgmma kernel's dimension slices.
    _cuda.reset_launches()
    idx128 = nns(q128, r128, version=9, device="cuda")
    p1b_launches = _cuda.LAUNCHES[P1B]
    if _cuda.LAUNCHES[WG] < 1 or p1b_launches != _cuda.LAUNCHES[WG]:
        raise AssertionError(f"nns(version=9) at k=128 launched {dict(_cuda.LAUNCHES)}")
    r128_dm, _ = prepare_refs(r128, 4096, dev)
    want128 = fused_min_idx(torch.as_tensor(q128, device=dev), r128_dm, 65536)[1].cpu().numpy()
    if not np.array_equal(idx128, want128):
        raise AssertionError("nns(version=9) at k=128 differs from the v4 kernel")
    _log(f"[kernel] nns(version=9) 1024 x 65536 k=128: {p1b_launches} wgmma phase-1 "
         f"launch(es), no mma.sync; answers equal the v4 kernel's")
    del r128_dm
    v4_16_ms, _ = cuda_ms(fused_min_idx, q16_dev10k, r16_dm, N_REFS)
    _log(f"[kernel] fused_argmin 10000 x 1M k=16 (v4, same call): {v4_16_ms:.4f} ms")

    # 8. The v9 main path: 1M 16-D refs, W distinct 10K batches.
    engine = NNEngine(9, device="cuda")
    t0 = time.perf_counter()
    engine.build(r16_1m)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    mx = engine._built
    if not isinstance(mx, MXUExpansion):
        raise AssertionError(f"NNEngine(9) built {type(mx).__name__}")
    rng = np.random.default_rng(SEED + 1)
    batches16 = [q16_10k] + [rng.random((N_QUERIES, K16), dtype=np.float32)
                             for _ in range(W - 1)]
    # Record the drain's own phase-1 launches (inputs and outputs) to hold
    # them against the plain version below; the count stays the wrapper's.
    drain_phase1 = []

    def _recorded(qc, rc, r2h, tile_n, ts, rc_t=None):
        out = phase1(qc, rc, r2h, tile_n, ts, rc_t=rc_t)
        drain_phase1.append(((qc, rc, r2h, tile_n, ts), rc_t, out))
        return out

    # And the rows of each full scan (v3 at the drain's own small m).
    full_scan_rows, full_scan = [], mxe._full_scan_rows

    def _full_scan_recorded(qb, refs_t, n):
        full_scan_rows.append(qb.shape[0])
        return full_scan(qb, refs_t, n)

    mxe.phase1, mxe._full_scan_rows = _recorded, _full_scan_recorded
    try:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        served16 = engine.query_many(batches16)
        queue_ms = (time.perf_counter() - t0) * 1e3
        launches["expansion_phase1_wgmma"] = _cuda.LAUNCHES["expansion_phase1_wgmma"]
    finally:
        mxe.phase1, mxe._full_scan_rows = phase1, full_scan
    launches["expansion_phase1"] = p1b_launches  # the v9 path at k = 128, phase 7
    _log(f"[v9] launches during query_many: {dict(_cuda.LAUNCHES)}; full scans of "
         f"{full_scan_rows} rows")
    if launches["expansion_phase1_wgmma"] < 1:
        raise AssertionError("kernel expansion_phase1_wgmma was not launched by the v9 main path")
    allq = np.concatenate(batches16)
    served_all = np.concatenate(served16)
    want = torch.cat([fused_min_idx(torch.as_tensor(b, device=dev), r16_dm, N_REFS)[1]
                      for b in batches16]).cpu().numpy()
    if not np.array_equal(served_all, want):
        raise AssertionError(f"v9 differs from the v4 kernel in "
                             f"{int((served_all != want).sum())} of {len(want)} answers")
    _log(f"[v9] all {len(want)} answers equal the v4 kernel's")
    # The drain's phase-1 launch against the plain version, in 10K-row
    # chunks (rows are independent), with the drain's own delta.
    (args_main, rc_t_main, kern_main), = drain_phase1
    qc_main = args_main[0]
    m_main = qc_main.shape[0]
    delta_main = mx.stage_queries(allq).delta
    plain_ms_main, parts = 0.0, []
    for lo in range(0, m_main, N_QUERIES):
        ms, out = cuda_ms(phase1_plain, qc_main[lo:lo + N_QUERIES], *args_main[1:],
                          iters=1, warmup=0)
        plain_ms_main += ms
        parts.append(out)
    plain_main = tuple(torch.cat(p) for p in zip(*parts))
    del parts
    err_main, text = _phase1_check("expansion_phase1_wgmma on the drain's launch", kern_main,
                                   plain_main, delta_main)
    kern_ms_main, _ = cuda_ms(phase1, *args_main, rc_t_main)
    # The mma.sync kernel on the same launch, through its own entry point.
    args_mma = (qc_main, mx.rc.contiguous(), *args_main[2:])
    mma_ms_main, mma_main = cuda_ms(mxe._phase1_cuda, *args_mma, None, "mma_sync")
    err_mma, text_mma = _phase1_check("expansion_phase1 (mma.sync) on the drain's launch",
                                      mma_main, plain_main, delta_main)
    main_bound = phase1_bound(m_main, N_REFS, K16)
    lib = _cuda.library()
    slots = {r: mxe._phase1_slots(lib, mx.kp, dev, r, mx.ts) for r in ("wgmma", "mma_sync")}
    n_tiles = mx.rc.shape[1] // mx.tile_n
    _log(f"[v9] phase 1 as the drain launched it ({m_main} x 1M k=16, bound "
         f"{main_bound[0]:.4f} ms ({main_bound[1]}), plain {plain_ms_main:.4f} ms in 10K-row "
         f"chunks): wgmma {kern_ms_main:.4f} ms ({kern_ms_main * N_QUERIES / m_main:.4f} ms "
         f"per 10K rows, {mxe.phase1_splits(m_main, n_tiles, slots['wgmma'])} range(s), "
         f"{slots['wgmma']} block slots; {text}); mma.sync {mma_ms_main:.4f} ms "
         f"({mma_ms_main * N_QUERIES / m_main:.4f} per 10K rows, "
         f"{mxe.phase1_splits(m_main, n_tiles, slots['mma_sync'])} range(s), "
         f"{slots['mma_sync']} block slots; {text_mma})")
    results["expansion_phase1_wgmma"].insert(0, (err_main, kern_ms_main, plain_ms_main))
    results["expansion_phase1"].append((err_mma, mma_ms_main, plain_ms_main))
    del drain_phase1, args_main, args_mma, kern_main, qc_main, mma_main, plain_main
    sub16, dmin16 = oracle16
    _gate("v9 batch 0 (the ladder's 512 rows)", served16[0][sub16], q16_1m[sub16], r16_1m,
          dmin16)
    _, _, cert = mx.query_min_idx_cert(allq)
    bad = np.flatnonzero(~cert)
    nchk = min(128, len(bad))
    pick = bad[np.random.default_rng(5).choice(len(bad), nchk, replace=False)] if nchk else bad
    if nchk:
        _, dmin_bad = _oracle_f64_card(allq[pick], r16_1m, dev)
        _gate(f"v9 uncertified rows ({nchk} of {len(bad)}, float64 scan on the card)",
              served_all[pick], allq[pick], r16_1m, dmin_bad)
    # Phase 1's own error on batch 0: |min1 - exact min e| over the gated rows.
    st0 = mx.stage_queries(q16_1m[sub16])
    min1_0 = phase1(_cat_q(*split_bf16x3(st0.q_dev)), mx.rc, mx.r2h, mx.tile_n, mx.ts,
                    rc_t=mx.rc_t)[0]
    q_sub = q16_1m[sub16].astype(np.float64)
    e_exact = 0.5 * (dmin16 - (q_sub ** 2).sum(axis=1))
    # Relative to the delta of these 512 rows, at most the drain's.
    err_ratio = float(np.abs(min1_0.double().cpu().numpy() - e_exact).max()) / st0.delta
    t0 = time.perf_counter()
    engine.query_many(batches16)
    drain_ms = (time.perf_counter() - t0) * 1e3 / W
    torch.cuda.reset_peak_memory_stats()
    engine.query_many(batches16)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    _log(f"[v9] build {build_ms:.1f} ms; query_many over {W} batches {queue_ms / W:.3f} "
         f"ms/batch (first call), {drain_ms:.3f} ms/batch (second call, host clock, "
         f"upload and download included); certified {int(cert.sum())}/{len(cert)} "
         f"({cert.mean():.6f}); phase-1 max |min1 - f64 e| over batch 0's "
         f"{len(sub16)} gated rows {err_ratio:.6f} delta; device memory peak "
         f"{peak_mb:.0f} MiB; promotions deferred {engine.promotions_deferred}")
    for s_, qb in zip(served16, batches16):
        if s_.shape != (qb.shape[0],) or s_.min() < 0 or s_.max() >= N_REFS:
            raise AssertionError("v9 query_many returned out-of-range indices")
    del engine, mx, mx16

    # 9. Results, each kernel at its main path's shape: one 10K batch for
    # the scan, the 8-query fallback bucket for the fused kernel, 1024 x 1M
    # k=3 for the ladder's kernels, the drain's 640K x 1M k=16 launch for
    # the wgmma kernel's row, and for phase 1 at the padded and sliced kp
    # (the "expansion_phase1" row, counting every phase-1 launch) the v9
    # path at 1024 x 65536 k=128, with 1024 x 1M k=24 beside it and the
    # mma.sync kernel's times on the same inputs and on the drain's launch
    # as yardsticks.
    main_rows = {
        "cell_scan": (results["cell_scan"][0], cell_bounds[0], "one 10K batch, k=3"),
        "fused_argmin": (results["fused_argmin"][0], fused_bound(8, N_REFS, K),
                         "8 x 1M k=3 (the fallback bucket)"),
        "expansion_phase1": (p1b_row, phase1_bound(1024, 65536, 128),
                             "1024 x 65536 k=128 (nns(version=9), dimension slices)"),
        "expansion_phase1_wgmma": (results["expansion_phase1_wgmma"][0], main_bound,
                                   f"{m_main} x 1M k=16 (the v9 drain's launch)"),
        **{name: (results[name][1], fused_bound(1024, N_REFS, K), "1024 x 1M k=3")
           for name in ladder_launches},
    }
    kernels = []
    for name, source, replaces in (
        ("cell_scan", "nns_tpu_torch/csrc/cell_scan.cu", "nns_tpu/kernels/cell_list.py:55"),
        ("fused_argmin", "nns_tpu_torch/csrc/fused_argmin.cu", "nns_tpu/kernels/pallas_fused.py:115"),
        ("fused_point_major", "nns_tpu_torch/csrc/fused_point_major.cu",
         "nns_tpu/kernels/pallas_fused.py:231"),
        ("fused_streaming", "nns_tpu_torch/csrc/fused_streaming.cu",
         "nns_tpu/kernels/pallas_fused.py:363"),
        ("fused_queries_resident", "nns_tpu_torch/csrc/fused_queries_resident.cu",
         "nns_tpu/kernels/pallas_fused.py:302"),
        ("two_level", "nns_tpu_torch/csrc/two_level.cu", "nns_tpu/kernels/pallas_fused.py:453"),
        ("expansion_phase1", "nns_tpu_torch/csrc/expansion_phase1.cu",
         "nns_tpu/kernels/mxu_expansion.py:126"),
        ("expansion_phase1_wgmma", "nns_tpu_torch/csrc/expansion_phase1.cu",
         "nns_tpu/kernels/mxu_expansion.py:126"),
    ):
        main, (bound_ms, bound_by), shape = main_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": shape, "launches": ladder_launches.get(name, launches.get(name)),
            "max_abs_err": max(r[0] for r in results[name]),
            "ms": main[1], "plain_ms": main[2],
            # No one PyTorch call computes an argmin of distances or the
            # phase-1 carries.
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        if name in device_ms:
            kernels[-1]["device_ms"] = device_ms[name]
        # Second shapes: the scan on the skewed batch, the ladder's kernels
        # (and v4 beside them) at 1024 x 1M k=16.
        if name == "cell_scan":
            _, ms, p_ms = results[name][1]
            kernels[-1].update(shape_skewed=f"skewed 10K batch (QM={skew_qm})", ms_skewed=ms,
                               plain_ms_skewed=p_ms, bound_ms_skewed=cell_bounds[1][0])
        if name in k16_row:
            _, ms, p_ms = results[name][k16_row[name]]
            kernels[-1].update(ms_k16=ms, plain_ms_k16=p_ms,
                               bound_ms_k16=fused_bound(1024, N_REFS, K16)[0])
        if name == "expansion_phase1":
            # phase1_kernel (mma.sync), no route any more, on the same inputs.
            y128, y24 = (yardsticks[n] for n in (
                "1024 x 65536 k=128 (dimension slices)", "1024 x 1M k=24 (blocks padded to 32 dims)"))
            kernels[-1].update(
                yardstick={"shape": "1024 x 65536 k=128, forced to phase1_kernel (mma.sync)",
                           "ms": y128[1], "plain_ms": y128[2], "bound_ms": bound_ms},
                yardstick_drain={
                    "shape": f"{m_main} x 1M k=16 (the v9 drain's launch, forced to "
                             "phase1_kernel)",
                    "ms": mma_ms_main, "plain_ms": plain_ms_main, "bound_ms": main_bound[0]},
                shape_k24="1024 x 1M k=24 (blocks padded to 32 dims)", ms_k24=p1b_k24[1],
                plain_ms_k24=p1b_k24[2], bound_ms_k24=phase1_bound(1024, N_REFS, 24)[0],
                yardstick_ms_k24=y24[1])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
