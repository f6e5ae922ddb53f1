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
5. the ladder's kernels (v3 point-major, v5 streaming, v6 queries-resident,
   v7 two-level) against their plain versions at 10000 x 1M k=3, 1024 x 1M
   k=3, 1024 x 1M k=16, duplicate ties and an unaligned 33 x 777 k=5, with
   the same tolerance 0 and timing as phase 2;
6. the ladder: ``nns(version=v)`` for v = 0..7 at 1024 x 1M, k = 3 and 16.
   Each answer passes the f64 gate on a 512-row subsample; v1, v3, v4, v5,
   v6 and v7 return equal index arrays; v0 (host scan) and v2 (expansion
   matmul) print how many indices they share with v4; each ladder kernel's
   launch count, zeroed just before its version's call, must grow during
   it; and v6 under a query budget below m * k * 4 must launch the v4
   kernel instead;
7. one JSON line of per-kernel results, then the device line last.
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
    from nns_tpu_torch.kernels.oracle import nn_oracle_f64
    from nns_tpu_torch.native import native_available
    from nns_tpu_torch.utils.timing import cuda_ms

    LADDER_KERNELS = (  # (launch key, wrapper, plain twin, point-major refs)
        ("fused_point_major", fl.fused_point_major_min_idx, fl.fused_point_major_plain, True),
        ("fused_streaming", fl.fused_streaming_min_idx, fl.fused_streaming_plain, False),
        ("fused_queries_resident", fl.fused_queries_resident_min_idx,
         fl.fused_queries_resident_plain, False),
        ("two_level", fl.two_level_min_idx, fl.two_level_plain, False),
    )
    VERSION_KERNEL = {3: "fused_point_major", 5: "fused_streaming",
                      6: "fused_queries_resident", 7: "two_level"}

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
    q16_1m, r16_1m = make_dataset(16, 1024, N_REFS, SEED)
    q16_dev = torch.as_tensor(q16_1m, device=dev)
    r16_1m_dm, _ = prepare_refs(r16_1m, 4096, dev)
    qu, ru = make_dataset(5, 33, 777, SEED)
    qu_dev = torch.as_tensor(qu, device=dev)
    ru_dm, _ = prepare_refs(ru, 4096, dev)
    ladder_cases = [  # (name, queries, dim-major refs, point-major refs, n, expect)
        ("10000 x 1M k=3", q_dev, r_dm, torch.as_tensor(refs, device=dev), N_REFS, None),
        ("1024 x 1M k=3", q1k, r_dm, torch.as_tensor(refs, device=dev), N_REFS, None),
        ("1024 x 1M k=16", q16_dev, r16_1m_dm, torch.as_tensor(r16_1m, device=dev), N_REFS,
         None),
        ("64 x 1M duplicate ties", torch.as_tensor(q_ties, device=dev), ties_dm,
         torch.as_tensor(ties, device=dev), N_REFS, _ties_ok),
        ("33 x 777 k=5 unaligned", qu_dev, ru_dm, torch.as_tensor(ru, device=dev), 777, None),
    ]
    # v4 at the same shapes, so that the rungs compare within one call (its
    # rows go after the fallback bucket's, which stays the JSON's row).
    for name, kernel_fn, plain_fn, pm in (*LADDER_KERNELS,
                                          ("fused_argmin", fused_min_idx, fused_min_idx_plain, False)):
        results.setdefault(name, [])
        for case, qc, rc_dm, rc_pm, n, expect in ladder_cases:
            results[name].append(_compare(f"{name} {case}", kernel_fn, plain_fn,
                                          (qc, rc_pm if pm else rc_dm, n), expect))
    del ladder_cases, r16_1m_dm

    # 6. The ladder through the public entry point.
    ladder_launches = {name: 0 for name, *_ in LADDER_KERNELS}
    for k in (3, 16):
        qk, rk = (queries[:1024], refs) if k == 3 else (q16_1m, r16_1m)
        sub_k = np.random.default_rng(4).choice(1024, GATE_ROWS, replace=False)
        t0 = time.perf_counter()
        _, dmin = nn_oracle_f64(qk[sub_k], rk)
        _log(f"[ladder] k={k}: f64 oracle of {GATE_ROWS} rows over 1M refs "
             f"{time.perf_counter() - t0:.1f} s (host)")
        answers = {}
        for version in range(8):
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
                ladder_launches[own] += _cuda.LAUNCHES[own]
            if idx.shape != (1024,) or idx.min() < 0 or idx.max() >= N_REFS:
                raise AssertionError(f"v{version} returned out-of-range indices")
            _gate(f"k={k} v{version} (512 subsample)", idx[sub_k], qk[sub_k], rk, dmin)
        for version in (1, 3, 5, 6, 7):
            if not np.array_equal(answers[version], answers[4]):
                bad = int((answers[version] != answers[4]).sum())
                raise AssertionError(f"k={k}: v{version} differs from v4 in {bad} indices")
        _log(f"[ladder] k={k}: v1, v3, v4, v5, v6, v7 index arrays equal; "
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

    # 7. Results.
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
    ):
        rows = results[name]
        # The main path's shape: one 10K batch for the scan, the 8-query
        # fallback bucket for the fused kernel, 1024 x 1M k=3 for the
        # ladder's kernels.
        main = rows[1] if name in ladder_launches else rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": ladder_launches.get(name, launches.get(name)),
            "max_abs_err": max(r[0] for r in rows),
            "ms": main[1], "plain_ms": main[2],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
