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
   (QM >= 512). v4 runs its own (query rows in registers on the
   producer/consumer ring, ref boxes by tensor-map copies, the ranges'
   winners folded inside its one launch) on the 8 x 1M fallback bucket,
   10000 x 1M, 1024 x 65536 k=16 and the duplicate ties;
3. the main path: ``NNEngine("cells", device="cuda").build`` over 1M uniform
   3-D refs (seed 1000) and ``query_many`` over W=64 distinct 10K-query
   batches drawn as bench.py draws them, plus one batch drawn over
   (-0.5, 1.5)^3 whose uncertified rows go through the fused fallback. The
   queue's raw (m, 3) rows go up in one copy, are binned by supercell on
   the card (``bin_queue``, ``place_queue``), each batch is scanned,
   ``cell_answer`` decodes every row on the card and lists the uncertified
   ones, one v4 call re-answers them and the queue's (m,) answers come
   down in one copy. The binning, placing, answer, scan and v4
   kernels' launch counts must grow during that query_many, and three f64
   oracle gates (batch 0, a random mid-queue batch, all fallback rows; up
   to 512 queries each) must read recall 1.0. Then (``_staging_phase``)
   ``query_staged`` is held bit-equal (ids, flags, d2; tolerance 0) to the
   host-staged path (``_dense_scatter``, the scan, the gather at the flat
   slots) on the uniform, the skewed and the out-of-box batch; the W=64
   uniform drain runs host-staged (``_host_staged_drain``: the drain before
   the device-side staging, from the public API) and device-staged
   (``query_queue``) in five alternating turns, equal answers, both medians
   and spreads printed; then bench.py's serial one-batch latency and the
   bytes each drain moves per batch. The binning kernels
   (``_binning_check``) run against their plain versions on the same card
   tensors for the drain's queue and for the skewed and out-of-box
   batches' queue: sids, counts and maxima bit-equal, each supercell's
   slots the same set, each row bit-equal at its slot and every other slot
   zero. The answer kernel (``_answer_check``) runs against its plain
   version on the drain's binned and scanned queue, on the skewed and
   out-of-box batches with a batch too skewed for a table and rows at the
   PAD_SENTINEL corner, and on the clustered queue below, part by part:
   answers bit-equal, the same certified counts and uncertified rows. A
   clustered 16-batch queue (``_parts_check``) whose tables pass
   the drain's slot budget is drained in parts, equal to the host-staged
   drain, its device memory printed;
4. the one-shot ``nns(version=4)`` and ``nns(version="cells")`` at 1M x 10K;
5. the ladder's kernels (v3 point-major, v5 streaming, v6 queries-resident,
   v7 two-level, and v4 beside them) against their plain versions at
   10000 x 1M k=3, 1024 x 1M k=3, 1024 x 1M k=16, duplicate ties and an
   unaligned 33 x 777 k=5 (v4's plain-load producer), v5 at 1024 x 65536
   k=128 (where a whole-k stage once outgrew shared memory), v7 and v4 at
   64 x 65536 k=4096 (where their whole-k query tiles once did), and v6
   and v7 on rows whose every distance overflows to +inf
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
7. v9's phase-1 kernels (the wgmma kernels, at every kp) against
   ``phase1_plain``: at 10000 x 1M and 1024 x 1M k=16, unaligned 33 x 777
   at k=16, 10 and 24, 1024 x 1M k=24 (blocks padded to 32 dims) and 1024 x
   65536 k=128 (dimension slices, the query tile resident): values within
   the engine's delta, ids equal wherever the plain runner-up is more than
   2 delta away (tensor cores sum in their own order, so no bit equality);
   and 64 x 1M integer-valued k=16 refs with exact duplicates, where every
   sum is exact and all six outputs must be equal. Then ``nns(version=9)``
   at 1024 x 65536 k=128, the path that runs phase 1 past a resident kp,
   with the launch counts zeroed just before: it must launch phase 1 and
   answer as the v4 kernel;
8. the v9 main path: ``NNEngine(9, device="cuda").build`` over the 1M 16-D
   refs (seed 1000) and ``query_many`` over W=64 distinct 10K batches. The
   ``expansion_phase1`` count must grow; the drain's own phase-1 launch
   (all 640K rows at once) is held against ``phase1_plain`` in 10K-row
   chunks with the same tolerance and timed; all 640K answers must equal
   the v4 kernel's; batch 0 passes the f64 gate on the ladder's 512-row oracle and
   up to 128 uncertified rows pass a float64 scan on the card; the rows of
   each v3 full scan the drain runs are printed. Its first call runs the
   one-time high-k probe (a KD tree and beam frontier over the 1M 16-D
   refs), which must reject uniform data: the engine stays the expansion
   engine, and the second call times the drain past the probe;
8b. v9's high-k ladder (``_high_k_phase``) on
   ``benchmarks/bench_k16_clustered.py``'s workload: 1M clustered 16-D refs
   (seed 1000), W_HK in-distribution 10K batches (a ref sample plus N(0,
   0.01) noise, ``default_rng(1001)``), ``EngineConfig(hk_probe_after=
   2048)``. The first batch crosses the probe, which must promote to a
   ``BeamIndex``; the rung (``_hk_beam``, ``_hk_budget``), the first
   batch's ms, the warmed drain's ms per batch, its coverage and the rows
   that went to ``_hk_fallback`` are printed; then one uniform
   out-of-distribution batch through the same engine, most of whose rows
   go to ``_hk_fallback`` (the retained expansion engine). The chunk-scan
   drain must launch ``fused_argmin`` and every fallback the wgmma kernel;
   a 512-row subsample of every batch and every fallback row pass the f64
   gate (a float64 scan on the card); v4 is held against its plain
   version on one chunk of the 16-D chunk scan, the wgmma kernel on the
   fallback's phase-1 launch, and v3 on the fallback's tier-2 rows (if the
   band refused any);
9. the tree family, k-NN and persistence (``_trees_phase``): ``nns(version=v)``
   for v = 10..13 at 1024 x 1M uniform k=3 (the ladder's queries), each
   held to the f64 gate on the ladder's 512 rows, and each engine's build
   and query timed apart; ``NNEngine(13).query_many`` over 1M clustered
   refs (seed 1000), W_TREES 10K batches drawn around the refs plus one
   batch over (-1e4, 1e4)^3, far enough that the certificate's relative
   margin leaves rows uncertified after the 4x retry: ``fused_argmin``
   (the beam's exact fallback) must launch during that batch, and a 512-row
   subsample and every uncertified row pass the f64 gate; the KD beam
   index's chunk scan (budget 128) on the same refs, which must launch
   ``fused_argmin`` and pass the gate; ``NNEngine("cells")`` over the
   clustered refs fed uniform batches until its coverage hysteresis
   promotes it to a ``BeamIndex``, gated before and after; ``query_topk``
   at k = 8 on v14 over the 1M uniform refs and on v13 over the clustered
   ones (10K queries), whose sorted f64 distances on 512 rows must equal a
   float64 top 8 on the card (rtol 1e-5); save, load and query again for
   v10-v14, answers equal; and the v4 kernel against ``fused_min_idx_plain``
   (tolerance 0) on the inputs these paths gave it: one chunk of the chunk
   scan (its shared candidate set, built as the scan builds it), the wide
   batch's fallback bucket and v14's before its promotion (and the v13
   drain's, if it fell back);
10. the benchmark harness (``_harness_phase``): ``harness.main`` over the
   reference grid, every version, on the card, with ``--warmup`` and
   ``--iters`` cut to HARNESS_WARMUP and HARNESS_ITERS; it prints its
   table, and all 15 x 10 records must read recall@1 1.0 (v8 on one card
   runs the v4 path);
11. the multi-device layer (``_multi_phase``) on ``Mesh.virtual(4)`` of the
   card (four shards, four local kernels and the real merge on one card)
   and on ``Mesh.virtual((2, 2))``: v8 (``sharded_argmin``) at 1024 x 1M,
   k = 3 and 16, bit-equal to ``nns(version=4)`` and gated on a float64
   scan; the 2-D merge at k = 3, equal to the 1-D answer; ``ring_argmin``
   at 1024 x 2^24 refs, bit-equal to the v4 kernel over them, gated, with
   ids past 2^23; ``ShardedCellEngine`` over the main path's 1M refs and
   its W batches plus the out-of-box one: answers, coverage and every
   winner table equal to the single-device drain's, two submit tokens,
   ``query_topk`` (k = 8) and save / load onto 1 and 2 shards, the per-shard
   device body's winners equal to one device's; then the v4
   kernel on one shard's block of v8 (1024 x 250,112) and the scan on one
   shard's group range of batch 0 against their plain versions (tolerance
   0). It prints v8's staged query ms beside v4's and the four-shard
   drain's ms per batch beside the single-device drain's, each also
   host-staged (``_host_staged_drain``), in turns: on one card that is
   the cost of the merge and the per-shard launches, not scaling;
12. one JSON line of per-kernel results, each row with the shape its ms,
   plain_ms and bound come from (the scan also on the skewed batch,
   ``*_skewed``, as are the binning and answer kernels on the skewed and
   out-of-box batches' queue; the ladder's kernels and v4 also at 1024 x 1M k=16,
   ``*_k16``): each kernel's main path (for the ``expansion_phase1`` row
   the drain's 640K-row launch; for the ``expansion_phase1_padded_sliced``
   row, phase 1 at the padded and sliced kp, v9 at 1024 x 65536 k=128 and
   1024 x 1M k=24 (``*_k24``)), then the device line last. ``ms`` brackets each wrapper
   call with CUDA events, so a launch shorter than its wrapper's host time
   reads the host time; the scan's and v4's rows, whose launches are that
   short, also give ``device_ms`` (``utils/timing.cuda_device_ms``: the
   device held busy while the calls are enqueued), v4's also at 1024 x 1M
   k=3 (``*_1024``) and k=16; v4's row also carries the tree paths'
   launches (``launches_trees``) and, per phase-9 shape, its ms, plain_ms
   and bound (``*_chunk``, ``*_wide_fallback``, ``*_v14_fallback``, and
   phase 8b's ``*_chunk16``), the wgmma kernel's and v3's rows their
   phase-8b launches (``*_hk_fallback``); these three rows carry phase 8b's
   launches (``launches_high_k``); v4's and the scan's rows carry phase
   11's launches (``launches_multi``) and their shard shapes (``*_shard``).
   Each phase prints its seconds (``[time]``).
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
W_TREES = 8  # in-distribution 10K batches of the v13 serving drain
W_HK = 8  # in-distribution 10K batches of the clustered 16-D ladder's drain
# The harness phase runs the reference grid with these, cut from the CLI's
# defaults (2 and 3) to keep the script near its earlier run time: the host
# versions (v0, v10, v12) take seconds per call at 1024 x 1M k=16.
HARNESS_WARMUP, HARNESS_ITERS = 1, 1
WIDE_BOX = (-1e4, 1e4)
K_NN = 8
RING_REFS = 1 << 24  # the ring's refs in phase 11 (192 MB at k = 3)


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


def _phase1_compare(name, args, rc_t, delta, exact=False):
    """Phase 1 on the card (``phase1``, which must launch) against
    phase1_plain on the same card tensors (``_phase1_check``), each timed.
    Returns (max_abs_err, kernel_ms, plain_ms)."""
    from nns_tpu_torch.kernels import _cuda
    from nns_tpu_torch.kernels.mxu_expansion import phase1, phase1_plain
    from nns_tpu_torch.utils.timing import cuda_ms

    before = _cuda.LAUNCHES["expansion_phase1"]
    k_ms, kern = cuda_ms(lambda: phase1(*args, rc_t=rc_t))
    if _cuda.LAUNCHES["expansion_phase1"] == before:
        raise AssertionError(f"{name}: phase1 launched no kernel")
    p_ms, plain = cuda_ms(phase1_plain, *args)
    err, text = _phase1_check(name, kern, plain, delta, exact)
    _log(f"[kernel] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, {text}")
    return err, k_ms, p_ms


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


def _topk_f64_card(queries, refs, kk, dev):
    """The kk smallest float64 squared distances of each query, ascending,
    by a chunked direct-form float64 scan on the card, independent of every
    kernel of the port."""
    r = torch.as_tensor(refs, device=dev).double()
    out = []
    for lo in range(0, len(queries), 16):
        q = torch.as_tensor(queries[lo:lo + 16], device=dev).double()
        d = ((q[:, None, :] - r[None]) ** 2).sum(dim=2)
        out.append(torch.topk(d, kk, dim=1, largest=False).values.cpu().numpy())
    return np.concatenate(out)


def _topk_gate(name, idx, queries, refs, dev):
    """The sorted f64 distances of the returned ids against the f64 top k
    (rtol 1e-5, as tests/test_api.py holds the JAX package)."""
    d = ((queries[:, None, :].astype(np.float64) - refs[idx].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(np.sort(d, axis=1), _topk_f64_card(queries, refs, idx.shape[1], dev),
                               rtol=1e-5, atol=1e-9)
    _log(f"[gate] {name}: sorted f64 distances of {idx.shape[1]} neighbours equal the f64 "
         f"top {idx.shape[1]} on {len(idx)} queries")


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
    from nns_tpu_torch.utils.bounds import (cell_answer_bound, cell_bin_bound, cell_bound,
                                            cell_place_bound, fused_bound, phase1_bound)
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
    t_main = t0 = time.perf_counter()
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

    cell = engine._built
    _cuda.reset_launches()
    t0 = time.perf_counter()
    served = engine.query_many(queue)
    queue_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    _log(f"[main] launches during query_many: {launches}")
    for name in ("cell_bin", "cell_place", "cell_answer", "cell_scan",
                 "fused_argmin"):  # ladder: phase 6
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched by the main path")

    flags = [cell.query_with_flags(b)[1] for b in queue]
    n_cert = int(sum(int(f.sum()) for f in flags))
    n_rows = len(queue) * N_QUERIES
    _log(f"[main] build {build_ms:.1f} ms (D={cell.D}, R_max={cell.R_max}); "
         f"query_many over {len(queue)} batches {queue_s * 1e3 / len(queue):.3f} ms/batch "
         f"(first call, with any promotion's build); certified {n_cert}/{n_rows} "
         f"({int(sum(int(f.sum()) for f in flags[:W]))}/{W * N_QUERIES} uniform, "
         f"{int(flags[W].sum())}/{N_QUERIES} out-of-box); the engine is now "
         f"{type(engine._built).__name__} (the coverage hysteresis read the out-of-box batch)")

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

    # The steady uniform drain, on the supercell index: a fresh engine, since
    # the out-of-box batch may have promoted this one, warmed by one untimed
    # drain (its fallback engine is staged at its first fallback), so the
    # timed call is a steady one as before.
    engine = NNEngine("cells", device="cuda").build(refs)
    engine.query_many(batches)
    t0 = time.perf_counter()
    engine.query_many(batches)
    drain_ms = (time.perf_counter() - t0) * 1e3 / W
    if not isinstance(engine._built, CellListEngine):
        raise AssertionError("the uniform drain left the supercell index")
    denses, _, _ = cell.stage_queue_ragged(batches)
    dq = [torch.as_tensor(d, device=dev) for d in denses]
    scan_ms, _ = cuda_ms(cell.query_queue_staged, dq, iters=5)
    torch.cuda.reset_peak_memory_stats()
    engine.query_many(batches[:8])
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    _log(f"[main] uniform drain W={W}: {drain_ms:.3f} ms/batch end to end "
         f"(one upload of the queue's (m, 3) rows; binning, placing, a scan per batch, the "
         f"decode and the sentinel mask on the card; one download of the certified counts, "
         f"one exact call for the queue's uncertified rows, one download of the answers); "
         f"device scans alone {scan_ms / W:.4f} ms/batch (CUDA events, median of 5); "
         f"device memory peak {peak_mb:.0f} MiB")
    _staging_phase(engine._built, batches, {"uniform": queries, "skewed": skew, "out-of-box": ood})
    binned = {}  # the drain's queue, then the skewed and out-of-box batches' queue
    for name, q in (("uniform W=64 queue", batches), ("skewed + out-of-box queue", [skew, ood])):
        binned[name] = _binning_check(name, engine._built, q)
    _parts_check(engine._built, batches[:16])
    for i, name in enumerate(("cell_bin", "cell_place")):
        results[name] = [row[i] for row in binned.values()]
    answer_row, device_ms["cell_answer"] = _answer_check("uniform W=64 queue", engine._built,
                                                         batches)
    # The answer kernel's other branches: the skewed and out-of-box batches,
    # a batch too skewed for any table (every row listed) and rows at the
    # PAD_SENTINEL corner (the f64 mask, at its margin too).
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from sentinel_corner import corner_rows

    too_skewed = (np.float32(0.5) + np.random.default_rng(SEED + 11).random(
        (2 * engine._built.q_max_limit() + 10, K), dtype=np.float32) * np.float32(1e-4))
    skewed_queue = [skew, ood, too_skewed.astype(np.float32), corner_rows(engine._built)]
    skewed_row, _ = _answer_check("skewed + out-of-box + too-skewed + corner queue",
                                  engine._built, skewed_queue)
    results["cell_answer"] = [answer_row, skewed_row]
    n_answer_skewed = sum(len(b) for b in skewed_queue)
    n_bin, bin_slots = binned["uniform W=64 queue"][2:]
    bin_bounds = {"cell_bin": (cell_bin_bound(n_bin, W, cell.D ** 3),
                               cell_bin_bound(2 * N_QUERIES, 2, cell.D ** 3)),
                  "cell_place": (cell_place_bound(n_bin, bin_slots),
                                 cell_place_bound(2 * N_QUERIES,
                                                  binned["skewed + out-of-box queue"][3]))}

    # 4. One-shot entry points.
    for version in (4, "cells"):
        t0 = time.perf_counter()
        idx = nns(queries, refs, version=version, device="cuda")
        ms = (time.perf_counter() - t0) * 1e3
        _log(f"[nns] version={version!r}: {ms:.1f} ms one-shot (build included)")
        _gate(f"nns(version={version!r}) (512 subsample)", idx[sub], queries[sub], refs)

    _log(f"[time] phases 1-4 {time.perf_counter() - t_main:.1f} s")
    t_phases = time.perf_counter()

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
    # v4's device time alone at the ladder's 1024 x 1M, k = 3 and 16.
    v4_device_1024 = {k: cuda_device_ms(fused_min_idx, qc, rc, N_REFS)[0]
                      for k, qc, rc in ((3, q1k, r_dm), (16, q16_dev, r16_dm))}
    _log(f"[kernel] fused_argmin 1024 x 1M device ms: k=3 {v4_device_1024[3]:.4f}, "
         f"k=16 {v4_device_1024[16]:.4f}")
    # v5 where a whole-k stage outgrew the opt-in shared memory (k >= 56):
    # the sliced instance, 16 dims per stage.
    q128s, r128s = make_dataset(128, 1024, 65536, SEED)
    results["fused_streaming"].append(_compare(
        "fused_streaming 1024 x 65536 k=128 (sliced)", fl.fused_streaming_min_idx,
        fl.fused_streaming_plain,
        (torch.as_tensor(q128s, device=dev), prepare_refs(r128s, 4096, dev)[0], 65536)))
    del q128s, r128s
    # v7 and v4 at a k whose whole-k query tiles once outgrew the opt-in
    # shared memory (from k = 3633): the sliced instances, 256 slices of 16
    # dims.
    q4k, r4k = make_dataset(4096, 64, 65536, SEED)
    args4k = (torch.as_tensor(q4k, device=dev), prepare_refs(r4k, 4096, dev)[0], 65536)
    for name, kernel_fn, plain_fn in (("two_level", fl.two_level_min_idx, fl.two_level_plain),
                                      ("fused_argmin", fused_min_idx, fused_min_idx_plain)):
        results[name].append(_compare(f"{name} 64 x 65536 k=4096 (sliced)", kernel_fn, plain_fn,
                                      args4k))
    del q4k, r4k, args4k
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
    oracles = {}  # k -> (the ladder's 512 rows, their f64 min distances)
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
        oracles[k] = (sub_k, dmin)
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

    # 7. The phase-1 kernels against their plain version.
    mx16 = MXUExpansion(r16_1m, device=dev)
    q16_dev10k = torch.as_tensor(q16_10k, device=dev)
    # P1: the row of phase 1 at kp % 16 == 0 with the query tile resident
    # (the drain's launch); P1B: phase 1 at the padded and sliced kp (the
    # k = 128 path). Both count under the one launch key, P1.
    P1, P1B = "expansion_phase1", "expansion_phase1_padded_sliced"
    results[P1], results[P1B] = [], []

    def _phase1_case(name, eng, q, row_key, exact=False):
        # Phase 1 on the card against one plain run, the row to
        # results[row_key]. Returns (max_abs_err, kernel_ms, plain_ms).
        st = eng.stage_queries(q)
        args = (_cat_q(*split_bf16x3(st.q_dev)), eng.rc, eng.r2h, eng.tile_n, eng.ts)
        row = _phase1_compare(f"phase 1 {name}", args, eng.rc_t, st.delta, exact)
        results[row_key].append(row)
        return row

    _phase1_case("10000 x 1M k=16", mx16, q16_10k, P1)
    _phase1_case("1024 x 1M k=16", mx16, q16_1m, P1)
    rng_int = np.random.default_rng(SEED + 2)
    r_int = rng_int.integers(0, 4, (N_REFS, K16)).astype(np.float32)
    q_int = rng_int.integers(0, 4, (64, K16)).astype(np.float32)
    for i, j in enumerate((0, 300_000, 999_999, 512_345)):  # ties across ref ranges
        r_int[j] = q_int[i]
        r_int[(j + 500_000) % N_REFS] = q_int[i]
    mx_int = MXUExpansion(r_int, device=dev)
    _phase1_case("64 x 1M k=16 integer duplicate ties (exact)", mx_int, q_int, P1, exact=True)
    del mx_int, r_int
    for k_u, key in ((16, P1), (10, P1), (24, P1B)):
        q_u, r_u = make_dataset(k_u, 33, 777, SEED)
        _phase1_case(f"33 x 777 k={k_u} unaligned", MXUExpansion(r_u, device=dev), q_u, key)
    q24, r24 = make_dataset(24, 1024, N_REFS, SEED)
    p1b_k24 = _phase1_case("1024 x 1M k=24 (blocks padded to 32 dims)",
                           MXUExpansion(r24, device=dev), q24, P1B)
    del q24, r24
    q128, r128 = make_dataset(128, 1024, 65536, SEED)
    p1b_row = _phase1_case("1024 x 65536 k=128 (dimension slices)",
                           MXUExpansion(r128, device=dev), q128, P1B)
    # The path that runs phase 1 at a kp past a resident query tile: v9 at
    # k = 128, now on the wgmma kernel's dimension slices.
    _cuda.reset_launches()
    idx128 = nns(q128, r128, version=9, device="cuda")
    p1b_launches = _cuda.LAUNCHES[P1]
    if p1b_launches < 1:
        raise AssertionError(f"nns(version=9) at k=128 launched {dict(_cuda.LAUNCHES)}")
    r128_dm, _ = prepare_refs(r128, 4096, dev)
    want128 = fused_min_idx(torch.as_tensor(q128, device=dev), r128_dm, 65536)[1].cpu().numpy()
    if not np.array_equal(idx128, want128):
        raise AssertionError("nns(version=9) at k=128 differs from the v4 kernel")
    _log(f"[kernel] nns(version=9) 1024 x 65536 k=128: {p1b_launches} phase-1 "
         f"launch(es); answers equal the v4 kernel's")
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
        launches[P1] = _cuda.LAUNCHES[P1]
    finally:
        mxe.phase1, mxe._full_scan_rows = phase1, full_scan
    launches[P1B] = p1b_launches  # the v9 path at k = 128, phase 7
    # The first call ran the one-time high-k probe (a KD tree and its beam
    # frontier over the 1M 16-D refs): on uniform data it must reject.
    if not engine._hk_probed or not isinstance(engine._built, MXUExpansion):
        raise AssertionError(f"the high-k probe on uniform 16-D data: probed "
                             f"{engine._hk_probed}, engine {type(engine._built).__name__}")
    _log(f"[v9] launches during query_many: {dict(_cuda.LAUNCHES)}; full scans of "
         f"{full_scan_rows} rows")
    if launches[P1] < 1:
        raise AssertionError("kernel expansion_phase1 was not launched by the v9 main path")
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
    err_main, text = _phase1_check("expansion_phase1 on the drain's launch", kern_main,
                                   plain_main, delta_main)
    kern_ms_main, _ = cuda_ms(phase1, *args_main, rc_t_main)
    main_bound = phase1_bound(m_main, N_REFS, K16)
    slots = mxe._phase1_slots(_cuda.library(), mx.kp, dev, mx.ts)
    n_tiles = mx.rc.shape[1] // mx.tile_n
    _log(f"[v9] phase 1 as the drain launched it ({m_main} x 1M k=16, bound "
         f"{main_bound[0]:.4f} ms ({main_bound[1]}), plain {plain_ms_main:.4f} ms in 10K-row "
         f"chunks): wgmma {kern_ms_main:.4f} ms ({kern_ms_main * N_QUERIES / m_main:.4f} ms "
         f"per 10K rows, {mxe.phase1_splits(m_main, n_tiles, slots)} range(s), "
         f"{slots} block slots; {text})")
    results[P1].insert(0, (err_main, kern_ms_main, plain_ms_main))
    del drain_phase1, args_main, kern_main, qc_main, plain_main
    sub16, dmin16 = oracles[16]
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
         f"ms/batch (first call, the one-time high-k probe inside: it rejected, the "
         f"engine stays {type(engine._built).__name__}), {drain_ms:.3f} ms/batch (second "
         f"call, host clock, upload and download included); certified "
         f"{int(cert.sum())}/{len(cert)} ({cert.mean():.6f}); phase-1 max |min1 - f64 e| "
         f"over batch 0's {len(sub16)} gated rows {err_ratio:.6f} delta; device memory "
         f"peak {peak_mb:.0f} MiB")
    for s_, qb in zip(served16, batches16):
        if s_.shape != (qb.shape[0],) or s_.min() < 0 or s_.max() >= N_REFS:
            raise AssertionError("v9 query_many returned out-of-range indices")
    del engine, mx, mx16
    _log(f"[time] phases 5-8 {time.perf_counter() - t_phases:.1f} s")

    # 8b. v9's high-k ladder on clustered 16-D data.
    hk_launches, hk_rows = _high_k_phase(dev)
    for name, rows in hk_rows.items():
        results[name].extend(r[1:4] for r in rows.values())

    # 9. The tree family, k-NN and persistence.
    tree_launches, tree_rows = _trees_phase(dev, queries, refs, oracles[3])
    results["fused_argmin"].extend(r[1:4] for r in tree_rows.values())

    # 10. The benchmark harness over the reference grid.
    _harness_phase()

    # 11. The multi-device layer on a virtual four-shard mesh of the card.
    multi_launches, multi_rows = _multi_phase(dev, queries, refs, batches, ood)
    for name, rows in multi_rows.items():
        results[name].extend(r[1:4] for r in rows.values())

    # 12. Results, each kernel at its main path's shape: one 10K batch for
    # the scan, the 8-query fallback bucket for the fused kernel, 1024 x 1M
    # k=3 for the ladder's kernels, the drain's 640K x 1M k=16 launch for
    # phase 1's row, and for phase 1 at the padded and sliced kp the v9
    # path at 1024 x 65536 k=128, with 1024 x 1M k=24 beside it.
    main_rows = {
        "cell_scan": (results["cell_scan"][0], cell_bounds[0], "one 10K batch, k=3"),
        "fused_argmin": (results["fused_argmin"][0], fused_bound(8, N_REFS, K),
                         "8 x 1M k=3 (the fallback bucket)"),
        P1: (results[P1][0], main_bound, f"{m_main} x 1M k=16 (the v9 drain's launch)"),
        P1B: (p1b_row, phase1_bound(1024, 65536, 128),
              "1024 x 65536 k=128 (nns(version=9), dimension slices)"),
        **{name: (results[name][1], fused_bound(1024, N_REFS, K), "1024 x 1M k=3")
           for name in ladder_launches},
        **{name: (results[name][0], bin_bounds[name][0],
                  f"the drain's queue, {W} x 10K rows (query_many)") for name in bin_bounds},
        "cell_answer": (results["cell_answer"][0], cell_answer_bound(n_bin),
                        f"the drain's queue, {W} x 10K rows (query_many)"),
    }
    skewed_shapes = {name: ("the skewed and out-of-box 10K batches' queue",
                            bin_bounds[name][1][0]) for name in bin_bounds}
    skewed_shapes["cell_answer"] = (
        "the skewed and out-of-box 10K batches, a batch too skewed for a table and "
        "sentinel-corner rows", cell_answer_bound(n_answer_skewed)[0])
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
        (P1, "nns_tpu_torch/csrc/expansion_phase1.cu", "nns_tpu/kernels/mxu_expansion.py:126"),
        (P1B, "nns_tpu_torch/csrc/expansion_phase1.cu", "nns_tpu/kernels/mxu_expansion.py:126"),
        # The drain's binning: the host's counting sort, which has no TPU kernel.
        ("cell_bin", "nns_tpu_torch/csrc/cell_bin.cu", "nns_tpu/native/nns_cpu.cpp:618"),
        ("cell_place", "nns_tpu_torch/csrc/cell_bin.cu", "nns_tpu/native/nns_cpu.cpp:618"),
        # The drain's decode and sentinel mask: the JAX drain's host unscatter.
        ("cell_answer", "nns_tpu_torch/csrc/cell_bin.cu", "nns_tpu/kernels/cell_list.py:647"),
    ):
        main, (bound_ms, bound_by), shape = main_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": shape, "launches": ladder_launches.get(name, launches.get(name)),
            "max_abs_err": max(r[0] for r in results[name]),
            "ms": main[1], "plain_ms": main[2],
            # No one PyTorch call computes an argmin of distances, the
            # phase-1 carries or a queue's supercell slots.
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
        if name in skewed_shapes:
            _, ms, p_ms = results[name][1]
            shape, b_ms = skewed_shapes[name]
            kernels[-1].update(shape_skewed=shape, ms_skewed=ms, plain_ms_skewed=p_ms,
                               bound_ms_skewed=b_ms)
        if name in k16_row:
            _, ms, p_ms = results[name][k16_row[name]]
            kernels[-1].update(ms_k16=ms, plain_ms_k16=p_ms,
                               bound_ms_k16=fused_bound(1024, N_REFS, K16)[0])
        if name == "fused_argmin":
            _, ms, p_ms = results[name][k16_row[name] - 1]
            kernels[-1].update(shape_1024="1024 x 1M k=3", ms_1024=ms, plain_ms_1024=p_ms,
                               device_ms_1024=v4_device_1024[3],
                               bound_ms_1024=fused_bound(1024, N_REFS, K)[0],
                               device_ms_k16=v4_device_1024[16])
        if name == P1B:
            kernels[-1].update(
                shape_k24="1024 x 1M k=24 (blocks padded to 32 dims)", ms_k24=p1b_k24[1],
                plain_ms_k24=p1b_k24[2], bound_ms_k24=phase1_bound(1024, N_REFS, 24)[0])
    # The launches the tree family's paths added (phase 9) beside v4's, and
    # v4 against its plain version at the shapes those paths gave it.
    kernels[1]["launches_trees"] = tree_launches
    # And the launches of the clustered 16-D ladder (phase 8b), with each
    # kernel held at the shapes that path gave it.
    hk_rows["fused_argmin"].update(tree_rows)
    # And the launches of the multi-device paths (phase 11), with v4 and the
    # scan held at the shard shapes.
    for row in kernels:
        if row["name"] in hk_launches:
            row["launches_high_k"] = hk_launches[row["name"]]
        if row["name"] in multi_launches:
            row["launches_multi"] = multi_launches[row["name"]]
        for key, (shape, _, ms, p_ms, b_ms) in [*hk_rows.get(row["name"], {}).items(),
                                                *multi_rows.get(row["name"], {}).items()]:
            row.update({f"shape_{key}": shape, f"ms_{key}": ms, f"plain_ms_{key}": p_ms,
                        f"bound_ms_{key}": b_ms})
    _log(f"[time] whole script {time.perf_counter() - t_main:.1f} s after the card's checks")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def _binning_check(name, eng, queue):
    """Phase 3's binning kernels against their plain versions on the same
    card tensors, for one queue as the drain uploads it: ``bin_queue``'s
    sids, per-supercell counts, per-batch maxima and non-finite count
    bit-equal to ``bin_queue_plain``'s (tolerance 0) and each (batch,
    supercell)'s slots the same set; ``place_queue`` on the drain's plan against
    ``place_queue_plain``: the same rows placed, each row's slot in the
    same (batch, supercell) block, the table bit-equal to the row at each
    row's slot and zero at every other slot, rows of a batch without a
    table past the last slot. Returns ((max_abs_err, ms, plain_ms) of the
    binning, the same of the placing, rows, slots)."""
    from nns_tpu_torch.kernels.cell_list import (_QUEUE_SLOTS, _upload_queue, bin_queue,
                                                 bin_queue_plain, place_queue,
                                                 place_queue_plain, queue_parts)
    from nns_tpu_torch.kernels.layouts import pow2_at_least
    from nns_tpu_torch.utils.timing import cuda_ms

    dev, groups = eng.device, eng.D ** 3
    sizes = [len(b) for b in queue]
    rows, offs = _upload_queue(queue, dev)
    b_ms, got = cuda_ms(bin_queue, rows, offs, max(sizes), eng.D, eng.mn, eng.W)
    bp_ms, want = cuda_ms(lambda: bin_queue_plain(rows, offs, eng.D, eng.mn, eng.W))
    sid, pos, counts, maxima = got
    for label, a, b in (("sid", sid, want[0]), ("counts", counts, want[2]),
                        ("maxima and non-finite count", maxima, want[3])):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"cell_bin {name}: {label} differs from bin_queue_plain's")
    maxima = maxima[:-1]
    batch = torch.repeat_interleave(torch.arange(len(queue), device=dev),
                                    torch.tensor(sizes, device=dev))
    key = (batch * groups + sid.long()) * (int(maxima.max()) + 1)
    if not torch.equal(torch.sort(key + pos.long())[0], torch.sort(key + want[1].long())[0]):
        raise AssertionError(f"cell_bin {name}: a supercell's slots differ from the plain's")
    q_max = np.array([pow2_at_least(max(int(x), 8)) if n else 0
                      for n, x in zip(sizes, maxima.tolist())], dtype=np.int64)
    q_max[q_max > eng.q_max_limit()] = 0
    plan, parts = queue_parts(q_max, groups, _QUEUE_SLOTS)
    if len(parts) != 1:
        raise AssertionError(f"cell_place {name}: the queue took {len(parts)} parts, not one")
    slots = parts[0][2]
    plan_d = torch.from_numpy(plan).to(dev)
    slot, t_slot = (torch.empty(len(rows), dtype=torch.int64, device=dev) for _ in range(2))
    p_ms, table = cuda_ms(place_queue, rows, offs, max(sizes), sid, pos, plan_d, slots, slot)
    pp_ms, t_table = cuda_ms(place_queue_plain, rows, offs, want[0], want[1], plan_d, slots,
                             t_slot)
    placed = slot < slots
    bits = rows.view(torch.int32)[placed]
    if not (torch.equal(placed, t_slot < slots)
            and torch.equal(placed, torch.from_numpy(q_max).to(dev)[batch] > 0)):
        raise AssertionError(f"cell_place {name}: the placed rows differ from the plain's")
    if not torch.equal(slot[placed] - pos[placed], t_slot[placed] - want[1][placed]):
        raise AssertionError(f"cell_place {name}: a row left its (batch, supercell) block")
    if not (torch.equal(table.view(torch.int32)[slot[placed]], bits)
            and torch.equal(t_table.view(torch.int32)[t_slot[placed]], bits)):
        raise AssertionError(f"cell_place {name}: a slot does not hold its row bit for bit")
    empty = torch.ones(slots, dtype=torch.bool, device=dev)
    empty[slot[placed]] = False
    if int(empty.sum()) != slots - int(placed.sum()) or table.view(torch.int32)[empty].any():
        raise AssertionError(f"cell_place {name}: two rows share a slot or a free slot is set")
    diff = (table[slot[placed]] - t_table[t_slot[placed]]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    _log(f"[bin] {name} ({len(queue)} batches, {len(rows)} rows, {slots} slots, q_max "
         f"{sorted(set(q_max.tolist()))}): bin_queue {b_ms:.4f} ms, plain {bp_ms:.4f} ms, sid, "
         f"counts and maxima bit-equal, each supercell's slots the same set; place_queue "
         f"{p_ms:.4f} ms, plain {pp_ms:.4f} ms, {int(placed.sum())} rows placed, each in its "
         f"block and bit-equal at its slot, max_abs_err {err}, every other slot zero")
    return (0.0, b_ms, bp_ms), (err, p_ms, pp_ms), len(rows), slots


def _answer_check(name, eng, queue):
    """Phase 3's answer kernel against its plain version on the same card
    tensors, for one queue as the drain bins and scans it, part by part:
    ``cell_answer``'s idx bit-equal to ``cell_answer_plain``'s at every
    row, each batch's certified count and the set of uncertified rows
    equal (tolerance 0). Returns ((max_abs_err, ms, plain_ms), device ms
    of the kernel), the times over every part's launch."""
    from nns_tpu_torch.kernels.cell_list import cell_answer, cell_answer_plain
    from nns_tpu_torch.utils.timing import cuda_device_ms, cuda_ms

    binned = eng._bin(queue)
    runs = []  # each part's (a, b, plan, win, slot); the parts' rows do not overlap in slot
    eng._scan_parts(binned, lambda *run: runs.append(run))
    rows, n, batches = binned.rows, len(binned.rows), len(queue)
    max_rows, lim = int(np.diff(binned.ends).max()), (2.0 * eng.halo) ** 2
    outs = {}

    def run(fn):
        idx, bad, counts = outs.setdefault(fn, (
            torch.empty(n, dtype=torch.int32, device=rows.device),
            torch.empty(n, dtype=torch.int32, device=rows.device),
            torch.empty(batches + 1, dtype=torch.int32, device=rows.device)))
        counts.zero_()  # the counts and the list's cursor start at 0 each call
        for a, b, plan, win, slot in runs:
            fn(rows, binned.offs[a:b + 1], max_rows, plan, win, slot, lim, idx, counts[a:b],
               bad, counts[batches:])
        return idx, counts, bad

    def plain(rows, offs, max_rows, *rest):
        return cell_answer_plain(rows, offs, *rest)

    ms, (idx, counts, bad) = cuda_ms(run, cell_answer)
    device, _ = cuda_device_ms(run, cell_answer)
    p_ms, (t_idx, t_counts, t_bad) = cuda_ms(run, plain)
    if not torch.equal(idx, t_idx):
        raise AssertionError(f"cell_answer {name}: {int((idx != t_idx).sum())} answers differ "
                             "from cell_answer_plain's")
    listed = int(counts[batches])
    if not (torch.equal(counts, t_counts)
            and torch.equal(torch.sort(bad[:listed])[0], torch.sort(t_bad[:listed])[0])):
        raise AssertionError(f"cell_answer {name}: the certified counts or the uncertified "
                             "rows differ from cell_answer_plain's")
    _log(f"[answer] {name} ({batches} batches, {n} rows, {len(runs)} part(s), "
         f"{int(binned.skewed.sum())} batch(es) with no table): cell_answer {ms:.4f} ms "
         f"(device {device:.4f} ms), plain {p_ms:.4f} ms, answers bit-equal, {n - listed} "
         f"certified and the same {listed} uncertified rows")
    return (0.0, ms, p_ms), device


def _parts_check(eng, batches) -> None:
    """Phase 3's clustered drain: ``batches`` with 600 rows of each packed
    into one small box, so that every batch takes a large table and the
    queue's tables pass the drain's slot budget. The device-binned drain
    places, scans and gathers them part by part (one ``cell_place`` launch
    a part), its answers equal the host-staged drain's, and its device
    memory above what the engine holds is printed beside what one table
    for the whole queue would take."""
    from nns_tpu_torch.kernels import _cuda
    from nns_tpu_torch.kernels.cell_list import _QUEUE_SLOTS, queue_parts

    rng = np.random.default_rng(SEED + 2)
    clustered = []
    for b, qb in enumerate(batches):
        qb = qb.copy()
        qb[:600] = (np.float32(0.05 + 0.05 * b)
                    + rng.random((600, 3), dtype=np.float32) * np.float32(0.004))
        clustered.append(qb)
    q_max = np.array([eng.stage(qb)[2] for qb in clustered], dtype=np.int64)
    _, parts = queue_parts(q_max, eng.D ** 3, _QUEUE_SLOTS)
    _cuda.reset_launches()
    got = eng.query_queue(clustered)
    if _cuda.LAUNCHES["cell_place"] != len(parts) or len(parts) < 2:
        raise AssertionError(f"the clustered drain placed {_cuda.LAUNCHES['cell_place']} parts, "
                             f"expected {len(parts)} (at least 2)")
    for a, b in zip(got, _host_staged_drain(eng, clustered), strict=True):
        if not np.array_equal(a, b):
            raise AssertionError("the clustered drain's answers differ from the host-staged")
    _answer_check("clustered queue in parts", eng, clustered)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.query_queue(clustered)
    ms = (time.perf_counter() - t0) * 1e3 / len(clustered)
    grew = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    whole = 20 * int(eng.D ** 3 * q_max.sum()) / 2 ** 20
    _log(f"[parts] clustered drain W={len(clustered)} (q_max {sorted(set(q_max.tolist()))}): "
         f"{len(parts)} parts of at most {_QUEUE_SLOTS} slots, answers equal to the "
         f"host-staged drain's; {ms:.3f} ms/batch (host clock, one call); device memory "
         f"above the engine's {grew:.0f} MiB, one table for the whole queue {whole:.0f} MiB")


def _host_staged_drain(eng, batches) -> list[np.ndarray]:
    """The drain as it was before the device-side staging, built from the
    public API: each batch scattered into its dense table on the host
    (``stage_queue_ragged``), one scan per table (``query_queue_staged``),
    one download of every table, the host unscatter, the sentinel mask and
    the exact re-answer."""
    denses, fslots, orders = eng.stage_queue_ragged(batches)
    tables = eng.query_queue_staged(denses)
    flat = torch.cat([t.reshape(-1) for t in tables]).cpu().numpy()
    offs = np.cumsum([0] + [t.numel() for t in tables])
    out = []
    for w, qb in enumerate(batches):
        idx, ok = eng.unscatter_queue(flat[offs[w]:offs[w + 1]], fslots[w], orders[w])
        risk = eng._sentinel_risk(qb)
        if risk is not None:
            ok &= ~risk
        out.append(eng._exact_rows(qb, idx, ok))
    return out


def _staging_phase(eng, batches, held) -> None:
    """Phase 3's device-side staging (module docstring): ``query_staged``
    bit-equal to the host-staged path on each batch of ``held``; the
    host-staged and the device-staged drain over ``batches`` in turns; the
    serial one-batch latency; the bytes each drain moves per batch."""
    from nns_tpu_torch.kernels.cell_list import cell_scan

    dev = eng.device
    for name, qb in held.items():
        packed, _, q_max = eng.stage(qb)
        signed, d2 = eng.query_staged(packed, q_max)
        dense, fslots = eng._dense_scatter(packed, q_max)
        dmin, sgid = cell_scan(torch.as_tensor(dense, device=dev), eng.halo_dm, eng.halo_ids_dev,
                               eng.halo2)
        slots = torch.as_tensor(fslots.astype(np.int64), device=dev)
        if not torch.equal(signed, sgid.reshape(-1)[slots]):
            raise AssertionError(f"query_staged's ids or flags differ on the {name} batch")
        if not torch.equal(d2.view(torch.int32), dmin.reshape(-1)[slots].view(torch.int32)):
            raise AssertionError(f"query_staged's d2 is not bit-equal on the {name} batch")
        _log(f"[stage] {name} batch (QM={q_max}): query_staged's ids, flags and d2 bit-equal "
             f"to the host-staged path's (tolerance 0); {int((signed >= 0).sum())}/{len(qb)} "
             f"certified")
    drains = {"host-staged": lambda: _host_staged_drain(eng, batches),
              "device-staged": lambda: eng.query_queue(batches)}
    for a, b in zip(*(fn() for fn in drains.values())):  # warm, and equal
        if not np.array_equal(a, b):
            raise AssertionError("the device-staged drain's answers differ from the host-staged")
    turns = {name: [] for name in drains}
    for i in range(5):
        for name in (("host-staged", "device-staged") if i % 2 == 0
                     else ("device-staged", "host-staged")):
            t0 = time.perf_counter()
            drains[name]()
            turns[name].append((time.perf_counter() - t0) * 1e3 / len(batches))
    for name, ms in turns.items():
        _log(f"[stage] {name} drain W={len(batches)}: median {np.median(ms):.3f} ms/batch, "
             f"spread {min(ms):.3f}-{max(ms):.3f} over five turns "
             f"({' / '.join(f'{x:.3f}' for x in ms)}; host clock, in turns)")
    serial = []
    for qb in batches[:4]:
        t0 = time.perf_counter()
        packed, _, q_max = eng.stage(qb)
        signed, d2 = eng.query_staged(packed, q_max)
        torch.stack([signed, d2.view(torch.int32)]).cpu()
        serial.append((time.perf_counter() - t0) * 1e3)
    _log(f"[stage] serial one batch (stage, query_staged, one (2, m) download; bench.py's "
         f"serial latency): min {min(serial):.3f} ms over 4 batches "
         f"({' / '.join(f'{x:.3f}' for x in serial)})")
    m = np.mean([len(b) for b in batches])
    qms = [eng.stage(b)[2] for b in batches]
    g = eng.D ** 3
    _log(f"[stage] bytes per batch: device-staged up {m * 3 * 4 / 1e3:.1f} KB (the (m, 3) "
         f"rows, in the queue's one upload), down {m * 4 / 1e3:.1f} KB (the (m,) winners), "
         f"plus per queue the offsets and plan up, the maxima down; host-staged up "
         f"{np.mean(qms) * g * 3 * 4 / 1e3:.1f} KB (the (G, QM, 3) table), down "
         f"{np.mean(qms) * g * 4 / 1e3:.1f} KB (the (G, QM) winners), G={g}, mean QM "
         f"{np.mean(qms):.1f}")


def _trees_phase(dev, queries, refs, oracle3) -> tuple[int, dict]:
    """Phase 9 (module docstring): v10-v13 one-shot, the v13 drain, the KD
    chunk scan, the v14 promotion, k-NN and persistence. Returns the
    fused_argmin launches of its paths and, per shape they gave the v4
    kernel, (shape, max_abs_err, ms, plain_ms, bound_ms) of the kernel
    against its plain version on those inputs."""
    from nns_tpu_torch import NNEngine, nns
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import _cuda, layouts
    from nns_tpu_torch.kernels.cell_list import CellListEngine
    from nns_tpu_torch.kernels.fused import as_f32, fused_min_idx, fused_min_idx_plain
    from nns_tpu_torch.trees.beam import (BeamIndex, chunk_scan_candidates, kd_beam_index,
                                          octree_beam_index)
    from nns_tpu_torch.trees.kdtree import KDTree
    from nns_tpu_torch.trees.octree import Octree
    from nns_tpu_torch.utils.bounds import fused_bound

    t_phase = time.perf_counter()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    v4_rows = {}

    def v4_case(key, shape, q, r_dm, n):
        """The v4 kernel against its plain version on inputs a tree path
        gave it (tolerance 0: indices and min_d2 bit-equal)."""
        err, ms, p_ms = _compare(f"fused {shape}", fused_min_idx, fused_min_idx_plain,
                                 (q, r_dm, n))
        v4_rows[key] = (shape, err, ms, p_ms, fused_bound(q.shape[0], n, q.shape[1])[0])

    def bucket_case(key, what, fb, q_bad):
        """The fallback's bucket: the rows padded to a power of two (>= 8),
        as ``FusedBruteForce.fallback`` pads them, over its staged refs."""
        q = layouts.pad_queries(as_f32(q_bad, dev), layouts.pow2_at_least(max(len(q_bad), 8)))
        v4_case(key, f"{what} fallback bucket: {q.shape[0]} x {fb.n} k=3 ({len(q_bad)} rows)",
                q, fb.r_dm, fb.n)

    sub3, dmin3 = oracle3
    q1k = queries[:1024]
    engines = {}
    for version in (10, 11, 12, 13):
        idx, ms = timed(lambda: nns(q1k, refs, version=version, device="cuda"))
        _gate(f"nns(version={version}) 1024 x 1M (512 subsample)", idx[sub3], q1k[sub3], refs,
              dmin3)
        eng, build_ms = timed(lambda: NNEngine(version, device="cuda").build(refs))
        idx2, query_ms = timed(lambda: eng.query(q1k))
        if version in (10, 12) and not np.array_equal(idx2, idx):
            raise AssertionError(f"v{version}: the engine differs from nns()")
        _gate(f"NNEngine({version}) 1024 x 1M (512 subsample)", idx2[sub3], q1k[sub3], refs, dmin3)
        engines[version] = eng
        _log(f"[trees] v{version} 1024 x 1M k=3: nns one-shot {ms:.1f} ms; engine build "
             f"{build_ms:.1f} ms, query {query_ms:.1f} ms")
    kd, oc = engines[11]._built, engines[13]._built
    _, kd_front_ms = timed(lambda: kd_beam_index(kd, device=dev))
    _, oc_front_ms = timed(lambda: octree_beam_index(oc, device=dev))
    _log(f"[trees] 1M uniform frontiers: KD {kd_front_ms:.1f} ms "
         f"(F={kd._beam.lo.shape[0]}, cap={kd._beam.pts.shape[1]}), octree {oc_front_ms:.1f} ms "
         f"(F={oc._beam.lo.shape[0]}, cap={oc._beam.pts.shape[1]})")

    # The v13 serving drain over 1M clustered refs.
    _, refs_c = make_dataset(3, 1, N_REFS, SEED, clustered=True)
    rng = np.random.default_rng(SEED + 7)
    near = [(refs_c[rng.integers(0, N_REFS, N_QUERIES)]
             + rng.normal(0, 0.01, (N_QUERIES, 3))).astype(np.float32) for _ in range(W_TREES)]
    wide = make_dataset(3, N_QUERIES, 1, SEED + 8, query_box=WIDE_BOX)[0]
    eng13, build13_ms = timed(lambda: NNEngine(13, device="cuda").build(refs_c))
    t0 = time.perf_counter()
    Octree.build(refs_c)
    oc_build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    KDTree.build(refs_c)
    kd_build_ms = (time.perf_counter() - t0) * 1e3
    beam13 = eng13._built._beam
    _, oc_front_c_ms = timed(lambda: octree_beam_index(eng13._built, device=dev))
    _log(f"[trees] 1M clustered: NNEngine(13).build {build13_ms:.1f} ms (octree build "
         f"{oc_build_ms:.1f} ms alone, its frontier {oc_front_c_ms:.1f} ms, F="
         f"{beam13.lo.shape[0]}, cap={beam13.pts.shape[1]}; KD build {kd_build_ms:.1f} ms)")
    _cuda.reset_launches()
    served, first_ms = timed(lambda: eng13.query_many(near))
    drain_launches = _cuda.LAUNCHES["fused_argmin"]
    _, drain_ms = timed(lambda: eng13.query_many(near))
    _cuda.reset_launches()
    served_wide = eng13.query_many([wide])[0]
    wide_launches = _cuda.LAUNCHES["fused_argmin"]
    if wide_launches < 1:
        raise AssertionError("the v13 wide batch did not launch fused_argmin")
    covs = [beam13.query_with_coverage(b)[1] for b in (*near, wide)]
    base_ok = [beam13.query_with_flags(b)[1] for b in (*near, wide)]
    _log(f"[trees] v13 query_many over {W_TREES} 10K batches: {first_ms / W_TREES:.3f} ms/batch "
         f"(first call), {drain_ms / W_TREES:.3f} (second call); coverage after the 4x retry "
         f"{np.mean(covs[:-1]):.6f} (base pass {np.mean([o.mean() for o in base_ok[:-1]]):.6f}), "
         f"fused_argmin launches {drain_launches}; wide batch {WIDE_BOX}: coverage "
         f"{covs[-1]:.6f} (base pass {base_ok[-1].mean():.6f}), fused_argmin launches "
         f"{wide_launches}")
    sub = np.random.default_rng(6).choice(N_QUERIES, GATE_ROWS, replace=False)
    _gate("v13 batch 0 (512 subsample)", served[0][sub], near[0][sub], refs_c)
    _gate("v13 wide batch (512 subsample)", served_wide[sub], wide[sub], refs_c)
    uncert = []
    for b, s_ in zip((*near, wide), (*served, served_wide)):
        _, ok = beam13.query_with_flags(b)
        bad = np.flatnonzero(~ok)
        ri, ro = beam13.query_with_flags(b[bad], 32)
        uncert.append((b[bad][~ro], s_[bad][~ro]))
    uq = np.concatenate([u[0] for u in uncert])
    ui = np.concatenate([u[1] for u in uncert])
    if len(uq) == 0:
        raise AssertionError("no v13 row went to the exact fallback")
    _gate(f"v13 uncertified rows (all {len(uq)}, float64 scan on the card)", ui, uq, refs_c,
          _oracle_f64_card(uq, refs_c, dev)[1])
    # The exact fallback answers the rows left after the retry, per
    # query_many call: all the drain's batches in one call, the wide batch
    # in another.
    bucket_case("wide_fallback", "v13 wide batch", beam13._fallback_engine(), uncert[-1][0])
    drain_bad = np.concatenate([u[0] for u in uncert[:-1]])
    if len(drain_bad):
        bucket_case("drain_fallback", "v13 drain", beam13._fallback_engine(), drain_bad)

    # The KD beam index's chunk scan.
    kd_c = KDTree.build(refs_c).device_index(dev)
    _cuda.reset_launches()
    (scan_idx, scan_cov), scan_ms = timed(lambda: kd_c.query_with_coverage(near[0], budget=128))
    scan_launches = _cuda.LAUNCHES["fused_argmin"]
    if scan_launches < 1:
        raise AssertionError("the chunk scan did not launch fused_argmin")
    st = kd_c.stage_queries(near[0])
    _, scan_ok = kd_c.query_staged_scan_with_flags(st, 128)
    _, scan_ms2 = timed(lambda: kd_c.query_staged_with_coverage(st, budget=128))
    _log(f"[trees] KD chunk scan (budget 128) on one 10K batch: {scan_ms:.3f} ms (first), "
         f"{scan_ms2:.3f} ms staged; scan coverage {scan_ok.mean():.6f}, after the retry "
         f"{scan_cov:.6f}; fused_argmin launches {scan_launches}")
    _gate("KD chunk scan (512 subsample)", scan_idx[sub], near[0][sub], refs_c)
    qc = st.q_dev[0]  # the first staged chunk, its candidates built as the scan builds them
    _, _, cand_dm, c, _ = chunk_scan_candidates(qc, kd_c.lo, kd_c.hi, kd_c.pts, kd_c.ids,
                                                kd_c.extras, kd_c.extras_ids, 128)
    v4_case("chunk", f"KD chunk scan, one chunk: {qc.shape[0]} x {c} k=3 (pitch "
            f"{cand_dm.shape[1]})", qc, cand_dm, c)
    del kd_c, qc, cand_dm

    # v14 over the clustered refs, fed uniform batches until it promotes.
    eng14 = NNEngine("cells", device="cuda").build(refs_c)
    if not isinstance(eng14._built, CellListEngine):
        raise AssertionError(f"NNEngine('cells') built {type(eng14._built).__name__}")
    cell14, on_cells = eng14._built, []
    _cuda.reset_launches()
    for i in range(4):
        qb = rng.random((N_QUERIES, 3), dtype=np.float32)
        on_cells.append(qb)
        before = type(eng14._built).__name__
        idx, ms = timed(lambda: eng14.query(qb))
        _gate(f"v14 uniform batch {i} on {before} (512 subsample)", idx[sub], qb[sub], refs_c)
        _log(f"[trees] v14 batch {i}: {ms:.1f} ms on {before}, now {type(eng14._built).__name__}")
        if isinstance(eng14._built, BeamIndex):
            break
    else:
        raise AssertionError("v14 did not promote to the beam index")
    promo_launches = _cuda.LAUNCHES["fused_argmin"]
    qb = rng.random((N_QUERIES, 3), dtype=np.float32)
    idx, ms = timed(lambda: eng14.query(qb))
    _gate("v14 after the promotion (512 subsample)", idx[sub], qb[sub], refs_c)
    _log(f"[trees] v14 on the promoted BeamIndex: {ms:.1f} ms per 10K batch; fused_argmin "
         f"launches up to the promotion {promo_launches}")
    for j, qb in enumerate(on_cells):  # each batch the supercell index answered
        _, ok14 = cell14.query_with_flags(qb)
        if not ok14.all():
            bucket_case("v14_fallback" + (f"_{j}" if j else ""),
                        f"v14 batch {j} before its promotion", cell14._fallback_engine(),
                        qb[~ok14])
    del eng14, cell14, on_cells

    # k-NN at k = 8.
    eng_cells = NNEngine("cells", device="cuda").build(refs)
    for name, eng, qk, rk in (("v14 1M uniform", eng_cells, queries, refs),
                              ("v13 1M clustered", eng13, near[0], refs_c)):
        eng.query_topk(qk[:1024], K_NN)  # warm
        (d2, idx), ms = timed(lambda: eng.query_topk(qk, K_NN))
        if idx.shape != (N_QUERIES, K_NN) or not np.isfinite(d2).all():
            raise AssertionError(f"{name} query_topk returned {idx.shape}")
        _log(f"[trees] {name} query_topk k={K_NN}: {ms:.1f} ms per 10K queries")
        _topk_gate(f"{name} query_topk", idx[sub], qk[sub], rk, dev)

    # Save, load and query again.
    engines[14] = eng_cells
    with tempfile.TemporaryDirectory() as tmp:
        for version, eng in engines.items():
            path = os.path.join(tmp, f"v{version}.npz")
            _, save_ms = timed(lambda: eng.save(path))
            loaded, load_ms = timed(lambda: NNEngine.load(path, version, device="cuda"))
            if not np.array_equal(loaded.query(q1k), eng.query(q1k)):
                raise AssertionError(f"v{version}: answers differ after save/load")
            _log(f"[trees] v{version} save {save_ms:.0f} ms ({os.path.getsize(path) / 2**20:.1f} "
                 f"MiB), load {load_ms:.0f} ms: answers equal")
    _log(f"[trees] phase {time.perf_counter() - t_phase:.1f} s")
    return drain_launches + wide_launches + scan_launches + promo_launches, v4_rows


def _high_k_phase(dev) -> tuple[dict, dict]:
    """Phase 8b (module docstring): v9's high-k ladder on
    ``benchmarks/bench_k16_clustered.py``'s workload. Returns, per kernel,
    the launches of the ladder's paths and, per shape they gave it, (shape,
    max_abs_err, ms, plain_ms, bound_ms) of the kernel against its plain
    version on those inputs."""
    from nns_tpu_torch import NNEngine
    from nns_tpu_torch.config import EngineConfig
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import _cuda, fused_ladder as fl
    from nns_tpu_torch.kernels import mxu_expansion as mxe
    from nns_tpu_torch.kernels.fused import fused_min_idx, fused_min_idx_plain
    from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion, phase1_plain
    from nns_tpu_torch.trees.beam import BeamIndex, chunk_scan_candidates
    from nns_tpu_torch.utils.bounds import fused_bound, phase1_bound
    from nns_tpu_torch.utils.timing import cuda_ms

    t_phase = time.perf_counter()
    _, refs = make_dataset(K16, 1, N_REFS, SEED, clustered=True)
    rng = np.random.default_rng(SEED + 1)

    def indist(m):
        base = refs[rng.integers(0, N_REFS, size=m)]
        return (base + rng.normal(0, 0.01, size=base.shape)).astype(np.float32)

    batches = [indist(N_QUERIES) for _ in range(W_HK)]
    eng = NNEngine(9, EngineConfig(hk_probe_after=2048), device="cuda")
    t0 = time.perf_counter()
    eng.build(refs)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    if not isinstance(eng._built, MXUExpansion):
        raise AssertionError(f"NNEngine(9) built {type(eng._built).__name__}")
    # The first batch crosses hk_probe_after: the expansion engine answers
    # it, then the probe builds the KD beam index and promotes.
    t0 = time.perf_counter()
    first = eng.query(batches[0])
    first_ms = (time.perf_counter() - t0) * 1e3
    bi = eng._built
    if not isinstance(bi, BeamIndex):
        raise AssertionError(f"the high-k probe kept {type(bi).__name__} on clustered data")
    beam, budget = eng._hk_beam, eng._hk_budget
    rung = f"chunk scan, budget {budget}" if budget is not None else f"per-query beam {beam}"

    _log(f"[high-k] 1M clustered 16-D: NNEngine(9).build {build_ms:.1f} ms; first 10K batch "
         f"{first_ms:.1f} ms (the expansion engine's answer, then the probe: KD build, "
         f"frontier F={bi.lo.shape[0]}, cap={bi.pts.shape[1]}, extras={bi.extras.shape[0]}); "
         f"rung {rung} (_hk_beam {beam}, _hk_budget {budget})")

    # Record what the serving path hands the retained engine and what the
    # engine's beam pass measured; the counts stay the wrappers'.
    fallbacks, covs, p1_launches, full_scans = [], [], [], []
    hk_fallback, query_with_coverage = bi.exact_fallback, bi.query_with_coverage
    phase1, full_scan = mxe.phase1, mxe._full_scan_rows

    def fallback_recorded(q_bad):
        out = hk_fallback(q_bad)
        fallbacks.append((q_bad, np.asarray(out)))
        return out

    def coverage_recorded(*a, **kw):
        idx, cov = query_with_coverage(*a, **kw)
        covs.append(cov)
        return idx, cov

    def phase1_recorded(qc, rc, r2h, tile_n, ts, rc_t=None):
        out = phase1(qc, rc, r2h, tile_n, ts, rc_t=rc_t)
        p1_launches.append(((qc, rc, r2h, tile_n, ts), rc_t, out))
        return out

    def full_scan_recorded(qb, refs_t, n):
        full_scans.append((qb, refs_t.reshape(-1, refs_t.shape[2]), n))
        return full_scan(qb, refs_t, n)

    bi.exact_fallback, bi.query_with_coverage = fallback_recorded, coverage_recorded
    eng.query_many(batches)  # warm: the chunk scan's shapes, the retry
    fallbacks.clear()
    covs.clear()
    mxe.phase1, mxe._full_scan_rows = phase1_recorded, full_scan_recorded
    try:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        served = eng.query_many(batches)
        drain_ms = (time.perf_counter() - t0) * 1e3 / W_HK
        drain_launches = dict(_cuda.LAUNCHES)
        drain_fb = list(fallbacks)
        # An out-of-distribution batch (uniform over the unit box) through
        # the same engine: most rows leave the beam uncertified and go to the
        # retained expansion engine.
        far = rng.random((N_QUERIES, K16), dtype=np.float32)
        _cuda.reset_launches()
        fallbacks.clear()
        t0 = time.perf_counter()
        served_far = eng.query(far)
        far_ms = (time.perf_counter() - t0) * 1e3
        far_launches = dict(_cuda.LAUNCHES)
        far_fb = list(fallbacks)
    finally:
        mxe.phase1, mxe._full_scan_rows = phase1, full_scan
    if not isinstance(eng._built, (BeamIndex, MXUExpansion)):
        raise AssertionError(f"the ladder left {type(eng._built).__name__}")
    st = bi.stage_queries(np.concatenate(batches))
    base_cov = float((bi.query_staged_scan_with_flags(st, budget) if budget is not None
                      else bi.query_staged_with_flags(st, beam))[1].mean())
    n_drain_fb = sum(len(q) for q, _ in drain_fb)
    n_far_fb = sum(len(q) for q, _ in far_fb)
    _log(f"[high-k] query_many over {W_HK} 10K batches (second call): {drain_ms:.3f} ms/batch; "
         f"coverage after the 4x retry {covs[0]:.6f} (base pass {base_cov:.6f}); rows to "
         f"_hk_fallback {n_drain_fb}; launches {({k: v for k, v in drain_launches.items() if v})}")
    _log(f"[high-k] out-of-distribution 10K batch: {far_ms:.1f} ms, coverage {covs[-1]:.6f}, "
         f"rows to _hk_fallback {n_far_fb}, launches "
         f"{({k: v for k, v in far_launches.items() if v})}; the engine is now "
         f"{type(eng._built).__name__} (_hk_budget {eng._hk_budget})")
    if budget is not None and drain_launches["fused_argmin"] < 1:
        raise AssertionError("the chunk-scan drain did not launch fused_argmin")
    if n_drain_fb and drain_launches["expansion_phase1"] < 1:
        raise AssertionError("the drain's _hk_fallback did not launch the wgmma kernel")
    if n_far_fb == 0 or far_launches["expansion_phase1"] < 1:
        raise AssertionError("the out-of-distribution batch did not reach the wgmma kernel "
                             f"through _hk_fallback ({n_far_fb} rows)")

    # The f64 gates: a subsample of every batch (the first as the probe's
    # batch answered it), and every _hk_fallback row.
    sub = np.random.default_rng(7).choice(N_QUERIES, GATE_ROWS, replace=False)
    for i, (qb, idx) in enumerate([(batches[0], first), *zip(batches, served),
                                   (far, served_far)]):
        what = ("first batch (probe)" if i == 0 else
                f"drain batch {i - 1}" if i <= W_HK else "out-of-distribution batch")
        _gate(f"high-k {what} (512 subsample, float64 scan on the card)", idx[sub], qb[sub],
              refs, _oracle_f64_card(qb[sub], refs, dev)[1])
    fb_q = np.concatenate([q for q, _ in drain_fb + far_fb])
    fb_idx = np.concatenate([i for _, i in drain_fb + far_fb])
    _gate(f"high-k _hk_fallback rows (all {len(fb_q)}, float64 scan on the card)", fb_idx, fb_q,
          refs, _oracle_f64_card(fb_q, refs, dev)[1])

    # The kernels at the shapes this path gave them: v4 on one chunk of the
    # 16-D chunk scan, the wgmma kernel on the fallback's phase-1 launch,
    # and v3 on the fallback's tier-2 rows, if the band refused any.
    v4_rows, p1_rows, pm_rows = {}, {}, {}
    if budget is not None:
        qc = bi.stage_queries(batches[0]).q_dev[0]
        _, _, cand_dm, c, _ = chunk_scan_candidates(qc, bi.lo, bi.hi, bi.pts, bi.ids, bi.extras,
                                                    bi.extras_ids, budget)
        shape = f"16-D chunk scan, one chunk: {qc.shape[0]} x {c} k=16 (pitch {cand_dm.shape[1]})"
        err, ms, p_ms = _compare(f"fused {shape}", fused_min_idx, fused_min_idx_plain,
                                 (qc, cand_dm, c))
        v4_rows["chunk16"] = (shape, err, ms, p_ms, fused_bound(qc.shape[0], c, K16)[0])
    args, rc_t, kern = p1_launches[-1]  # the out-of-distribution batch's fallback
    delta = eng._hk_mxu.stage_queries(far_fb[-1][0]).delta
    plain_ms, plain = cuda_ms(phase1_plain, *args, iters=1, warmup=0)
    err, text = _phase1_check("expansion_phase1 on _hk_fallback's launch", kern, plain, delta)
    kern_ms, _ = cuda_ms(phase1, *args, rc_t)
    m_fb = args[0].shape[0]
    shape = f"{m_fb} x 1M k=16 (_hk_fallback of the out-of-distribution batch)"
    p1_rows["hk_fallback"] = (shape, err, kern_ms, plain_ms, phase1_bound(m_fb, N_REFS, K16)[0])
    _log(f"[kernel] phase 1 {shape}: wgmma {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, {text}")
    if full_scans:
        qb, refs_pm, n = full_scans[-1]
        shape = f"{qb.shape[0]} x 1M k=16 (tier 2 under _hk_fallback, kp = {refs_pm.shape[1]})"
        err, ms, p_ms = _compare(f"fused_point_major {shape}", fl.fused_point_major_min_idx,
                                 fl.fused_point_major_plain, (qb, refs_pm, n))
        pm_rows["hk_fallback"] = (shape, err, ms, p_ms,
                                  fused_bound(qb.shape[0], n, refs_pm.shape[1])[0])
    _log(f"[high-k] phase {time.perf_counter() - t_phase:.1f} s")
    names = ("fused_argmin", "expansion_phase1", "fused_point_major")
    launches = {k: drain_launches[k] + far_launches[k] for k in names}
    return launches, dict(zip(names, (v4_rows, p1_rows, pm_rows)))


def _multi_phase(dev, queries, refs, batches, ood) -> tuple[dict, dict]:
    """Phase 11 (module docstring): the multi-device layer on a virtual
    four-shard mesh of the card. Returns, per kernel, the launches of its
    paths (each path driven with the counts zeroed just before it and read
    just after) and, per shard shape, (shape, max_abs_err, ms, plain_ms,
    bound_ms) of the kernel against its plain version there."""
    from nns_tpu_torch import nns
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import _cuda
    from nns_tpu_torch.kernels.cell_list import CellListEngine, cell_scan, cell_scan_plain
    from nns_tpu_torch.kernels.fused import FusedBruteForce, fused_min_idx, fused_min_idx_plain
    from nns_tpu_torch.parallel import (Mesh, ShardedBruteForce, ShardedCellEngine, ring_argmin,
                                        sharded_argmin, sharded_argmin_2d)
    from nns_tpu_torch.utils.bounds import cell_bound, fused_bound
    from nns_tpu_torch.utils.timing import cuda_ms

    t_phase = time.perf_counter()
    mesh4, mesh22 = Mesh.virtual(4, dev), Mesh.virtual((2, 2), dev)
    launches = {"fused_argmin": 0, "cell_scan": 0}
    label = "one card, four shards: the cost of the merge and the per-shard launches, not scaling"

    def path(name, fn, kernels):
        """Drive one path with the counts zeroed just before and read just
        after; each of ``kernels`` must have launched."""
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k in kernels:
            if _cuda.LAUNCHES[k] < 1:
                raise AssertionError(f"{name} did not launch {k}")
        for k in launches:
            launches[k] += _cuda.LAUNCHES[k]
        return out

    def equal(name, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name}: differs in {int((got != want).sum())} of {want.size}")

    # v8 on the 1-D mesh at the ladder's 1024 x 1M, k = 3 and 16, and on
    # the 2-D mesh at k = 3: bit-equal to nns(version=4), recall 1.0.
    v8_ms = {}
    for k in (3, 16):
        qk, rk = (queries[:1024], refs) if k == 3 else make_dataset(k, 1024, N_REFS, SEED)
        want = nns(qk, rk, version=4, device=dev)
        got = path(f"sharded_argmin k={k}", lambda: sharded_argmin(qk, rk, mesh4).cpu().numpy(),
                   ("fused_argmin",))
        equal(f"v8 1-D k={k}", got, want)
        _gate(f"v8 1-D 1024 x 1M k={k} (float64 scan on the card)", got, qk, rk,
              _oracle_f64_card(qk, rk, dev)[1])
        if k == 3:
            got2 = path("sharded_argmin_2d", lambda: sharded_argmin_2d(qk, rk, mesh22).cpu().numpy(),
                        ("fused_argmin",))
            equal("v8 2-D (2, 2) k=3", got2, got)
            _log("[multi] v8 2-D (2, 2) 1024 x 1M k=3: equal to the 1-D answer")
        eng8, eng4 = ShardedBruteForce(rk, mesh4), FusedBruteForce(rk, device=dev)
        q_dev = torch.as_tensor(qk, device=dev)
        v8_ms[k] = (cuda_ms(eng8.query, q_dev)[0], cuda_ms(eng4.query, q_dev)[0])
        _log(f"[multi] v8 1024 x 1M k={k}: equal to nns(version=4); staged query {v8_ms[k][0]:.4f} "
             f"ms on four shards, v4 {v8_ms[k][1]:.4f} ms (CUDA events, median of 5; {label})")
        if k == 3:
            shard_q, shard_blk, shard_n = q_dev, eng8.blocks[0], eng8.shard_n
        del eng8, eng4

    # The ring over 2^24 refs: bit-equal to the v4 kernel over them, recall
    # 1.0, and ids past 2^23 reached.
    q_r, r_r = make_dataset(3, 1024, RING_REFS, SEED)
    t0 = time.perf_counter()
    got = path("ring_argmin", lambda: ring_argmin(q_r, r_r, mesh4).cpu().numpy(),
               ("fused_argmin",))
    ring_ms = (time.perf_counter() - t0) * 1e3
    equal("ring 2^24", got, FusedBruteForce(r_r, device=dev).query(q_r).cpu().numpy())
    if got.max() < RING_REFS // 2:
        raise AssertionError(f"the ring's largest id {got.max()} is below {RING_REFS // 2}")
    _gate("ring 1024 x 2^24 k=3 (float64 scan on the card)", got, q_r, r_r,
          _oracle_f64_card(q_r, r_r, dev)[1])
    _log(f"[multi] ring 1024 x 2^24 k=3 on four shards: {ring_ms:.1f} ms one-shot (host padding, "
         f"upload and 16 launches); equal to the v4 kernel; largest id {got.max()}")
    del q_r, r_r

    # The sharded supercell drain over the main path's 1M refs and batches.
    queue = list(batches) + [ood]
    single = CellListEngine(refs, device=dev)
    sc = ShardedCellEngine(refs, mesh4)
    got, cov = path("the sharded drain", lambda: sc.query_queue(queue, return_coverage=True),
                    ("cell_scan", "fused_argmin"))
    want, cov_s = single.query_queue(queue, return_coverage=True)
    if cov != cov_s:
        raise AssertionError("the sharded drain's coverage differs from the single-device drain's")
    for w, (a, b) in enumerate(zip(got, want)):
        equal(f"sharded drain batch {w}", a, b)
    sub = np.random.default_rng(8).choice(N_QUERIES, GATE_ROWS, replace=False)
    _gate("sharded drain, out-of-box batch (512 subsample)", got[-1][sub], ood[sub], refs)
    denses = single.stage_queue_ragged(queue)[0]
    G = single.D ** 3
    for w, (t, t_s) in enumerate(zip(sc.query_queue_staged(denses),
                                     single.query_queue_staged(denses))):
        if not torch.equal(t[:G], t_s):
            raise AssertionError(f"sharded winner table {w} differs from the single-device one")
    for name, qb in (("batch 0", batches[0]), ("out-of-box", ood)):
        packed, _, q_max = single.stage(qb)
        got_w, want_w = sc.query_staged(packed, q_max)[0], single.query_staged(packed, q_max)[0]
        if not torch.equal(got_w, want_w):
            raise AssertionError(f"sharded query_staged differs from one device's on {name}")
    tokens = path("two submit tokens", lambda: [sc.query_submit(b) for b in batches[:2]],
                  ("cell_scan",))
    for b, t in zip(batches[:2], tokens):
        for x, y in zip(sc.query_collect(t), single.query_with_flags(b)):
            equal("submit/collect", x, y)
    topk = path("sharded query_topk", lambda: sc.query_topk(queries, K_NN), ())
    for x, y in zip(topk, single.query_topk(queries, K_NN)):
        equal("sharded query_topk", x, y)
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "cells.npz")
        sc.save(p)
        want0 = sc.query(batches[0])
        equal("CellListEngine.load", CellListEngine.load(p, device=dev).query(batches[0]), want0)
        equal("ShardedCellEngine.load (2 shards)",
              ShardedCellEngine.load(p, Mesh.virtual(2, dev)).query(batches[0]), want0)
    _log(f"[multi] sharded drain over W={len(queue)} (the out-of-box batch last): answers, "
         f"coverage, {len(denses)} host-staged winner tables and the per-shard device body's "
         f"winners (batch 0, out-of-box) equal the single-device drain's "
         f"(G={G}, g_pad={sc.g_pad}); two submit tokens, query_topk k={K_NN} and save/load onto "
         f"1 and 2 shards agree")
    # Timed in turns, each drain device-staged (query_queue) and
    # host-staged (the drain before the device-side staging), after one
    # warm run of each, the host-staged sharded drain's answers equal.
    drains = {"four shards": lambda: sc.query_queue(batches),
              "one device": lambda: single.query_queue(batches),
              "four shards, host-staged": lambda: _host_staged_drain(sc, batches),
              "one device, host-staged": lambda: _host_staged_drain(single, batches)}
    for w, (a, b) in enumerate(zip(drains["four shards, host-staged"](), got)):
        equal(f"host-staged sharded drain batch {w}", a, b)
    drains["one device, host-staged"]()
    drain = {name: [] for name in drains}
    for turn in range(2):
        for name in (list(drains) if turn == 0 else list(drains)[::-1]):
            t0 = time.perf_counter()
            drains[name]()
            drain[name].append((time.perf_counter() - t0) * 1e3 / len(batches))
    _log(f"[multi] uniform drain W={len(batches)}, in turns (ms/batch, host clock; {label}): "
         + "; ".join(f"{name} {' / '.join(f'{x:.3f}' for x in ms)}"
                     for name, ms in drain.items()))

    # The kernels at the shard shapes: v4 on one shard's block of v8, the
    # scan on one shard's group range of batch 0.
    rows = {}
    err, ms, p_ms = _compare(f"fused 1024 x {shard_n} k=3 (one of v8's four shards)",
                             fused_min_idx, fused_min_idx_plain, (shard_q, shard_blk, shard_n))
    rows["fused_argmin"] = {"shard": (f"1024 x {shard_n} k=3 (one of v8's four shards)", err, ms,
                                      p_ms, fused_bound(1024, shard_n, K)[0])}
    packed, _, q_max = single.stage(batches[0])
    dense, _ = single._dense_scatter(packed, q_max)
    gl = sc.g_local
    _, halo_dm, halo_ids = sc.shards[0]
    args = (torch.as_tensor(dense[:gl], device=dev), halo_dm, halo_ids, sc.halo2)
    shape = f"one shard's groups of one 10K batch (G={gl}, QM={q_max}, R_max={sc.R_max})"
    err, ms, p_ms = _compare(f"cell_scan {shape}", cell_scan, cell_scan_plain, args)
    real = int((packed[:, 3] < gl).sum())
    rows["cell_scan"] = {"shard": (shape, err, ms, p_ms,
                                   cell_bound(gl, q_max, sc.R_max, real, sc.avg_candidates)[0])}
    _log(f"[multi] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches, rows


def _harness_phase() -> None:
    """Phase 10 (module docstring): ``python -m nns_tpu_torch`` over the
    reference grid, every version, in this process on the card."""
    from nns_tpu_torch import harness

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grid.jsonl")
        argv = ["--grid", "reference", "--versions", "all", "--device", "cuda",
                "--warmup", str(HARNESS_WARMUP), "--iters", str(HARNESS_ITERS), "--jsonl", path]
        _log(f"[harness] python -m nns_tpu_torch {' '.join(argv[:-2])} (cut from --warmup 2 "
             f"--iters 3 to keep the script near its earlier run time)")
        rc = harness.main(argv)
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
    if rc != 0:
        raise AssertionError(f"the harness returned {rc}")
    bad = [r for r in recs if r["recall_at_1"] != 1.0]
    if len(recs) != 15 * 10 or bad or len({r["version"] for r in recs}) != 15:
        raise AssertionError(f"{len(recs)} records, below recall 1.0: {bad}")
    _log(f"[harness] {len(recs)} records of v0-v14 at recall@1 1.0 (v8 on one card runs v4); "
         f"phase {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
