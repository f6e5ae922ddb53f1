"""Smoke test of the PyTorch/CUDA port (nns_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, nvcc and g++, and exits non-zero (printing no
result) without them. Phases, each raising on failure:

0. the card's name and power limit (nvidia-smi);
1. build both CUDA kernels (and the native host library) from the sources;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: indices equal and min_d2 bit-equal (tolerance 0: both
   round every sub, mul and add to nearest, no FMA), times from CUDA events
   (median of 5);
3. the main path: ``NNEngine("cells", device="cuda").build`` over 1M uniform
   3-D refs (seed 1000) and ``query_many`` over W=64 distinct 10K-query
   batches drawn as bench.py draws them, plus one batch drawn over
   (-0.5, 1.5)^3 whose uncertified rows go through the fused fallback. Both
   kernels' launch counts must grow during that query_many, and three f64
   oracle gates (batch 0, a random mid-queue batch, all fallback rows; up
   to 512 queries each) must read recall 1.0;
4. the one-shot ``nns(version=4)`` and ``nns(version="cells")`` at 1M x 10K;
5. one JSON line of per-kernel results, then the device line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1000
N_REFS = 1_000_000
N_QUERIES = 10_000
W = 64
K = 3
GATE_ROWS = 512


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
    err = float((kd.double() - pd.double()).abs().max()) if kd.numel() else 0.0
    _log(f"[kernel] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
         f"indices equal, max_abs_err {err}")
    return err, k_ms, p_ms


def _gate(name, idx, queries, refs) -> float:
    from nns_tpu_torch.kernels.oracle import recall_at_1

    rec = recall_at_1(idx, queries, refs)
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
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import _cuda
    from nns_tpu_torch.kernels.cell_list import CellListEngine, cell_scan, cell_scan_plain
    from nns_tpu_torch.kernels.fused import fused_min_idx, fused_min_idx_plain, prepare_refs
    from nns_tpu_torch.native import native_available
    from nns_tpu_torch.utils.timing import cuda_ms

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
    _log(f"[build] CUDA kernels {build_s:.2f} s (nvcc {' '.join(_cuda.NVCC_FLAGS)}); "
         f"native host library {time.perf_counter() - t0:.2f} s")

    # 2. Kernels against their plain versions.
    queries, refs = make_dataset(K, N_QUERIES, N_REFS, SEED)
    results = {"fused_argmin": [], "cell_scan": []}

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

    cells = CellListEngine(refs, device=dev)
    _log(f"[kernel] 1M index: D={cells.D}, G={cells.D ** 3}, R_max={cells.R_max}, "
         f"halo={cells.halo:.4f}, avg candidates {cells.avg_candidates:.0f}")
    skew = queries.copy()
    skew[:600] = (np.float32(0.51) + np.random.default_rng(SEED).random(
        (600, 3), dtype=np.float32) * np.float32(0.01))
    for name, qb in (("cell_scan one 10K batch", queries), ("cell_scan skewed 10K batch", skew)):
        packed, _, q_max = cells.stage(qb)
        dense, _ = cells._dense_scatter(packed, q_max)
        args = (torch.as_tensor(dense, device=dev), cells.halo_dm, cells.halo_ids_dev, cells.halo2)
        results["cell_scan"].append(
            _compare(f"{name} (G={dense.shape[0]}, QM={dense.shape[1]}, R_max={cells.R_max})",
                     cell_scan, cell_scan_plain, args))
    if cells.stage(skew)[2] < 512:
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
    for name, count in launches.items():
        if count < 1:
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

    # 5. Results.
    kernels = []
    for name, source, replaces in (
        ("cell_scan", "nns_tpu_torch/csrc/cell_scan.cu", "nns_tpu/kernels/cell_list.py:55"),
        ("fused_argmin", "nns_tpu_torch/csrc/fused_argmin.cu", "nns_tpu/kernels/pallas_fused.py:115"),
    ):
        rows = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r[0] for r in rows),
            # The main path's shape: one 10K batch for the scan, the
            # 8-query fallback bucket for the fused kernel.
            "ms": rows[0][1], "plain_ms": rows[0][2],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
