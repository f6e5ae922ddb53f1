"""The v14 scan, v3, v5, v6, v7 and v9 phase-1 kernels of this tree against
those of another tree.

Run from the repository root on a machine with one CUDA device:
``python -m nns_tpu_torch.utils.kernel_report --parent DIR``, where DIR is
an unpacked copy of the tree to compare with (``git archive`` of the parent
commit). It prints the card's name and power limit, then

1. ptxas's registers, shared memory and spills for every kernel of
   ``csrc/cell_scan.cu``, ``csrc/fused_queries_resident.cu``,
   ``csrc/fused_streaming.cu``, ``csrc/fused_point_major.cu`` and
   ``csrc/two_level.cu`` of both trees (``nvcc -Xptxas -v`` with this
   tree's flags);
2. the times of both trees' kernels, each tree imported in a process of its
   own and called through its own public wrappers (``cell_list.cell_scan``,
   ``fused_ladder.fused_queries_resident_min_idx``,
   ``fused_point_major_min_idx``, ``fused_streaming_min_idx``,
   ``two_level_min_idx`` and ``mxu_expansion.phase1``), in turns
   (parent, this tree, this tree, parent). Every turn is timed by this tree's
   ``utils/timing``: ``cuda_ms`` (CUDA events around each wrapper call,
   median of 5; host time where it is longer than the kernel) and, beside
   it, ``cuda_device_ms`` (the device held busy while the calls are
   enqueued: device time alone), on the same inputs, with each shape's
   bound (``utils/bounds``) and both trees' outputs held bit-equal:
   ``cell_scan`` on one uniform 10K batch and on a skewed one over 1M
   uniform 3-D refs (seed 1000, as ``chip_smoke.py`` draws them); v6, v3,
   v5 and v7 at 1024 x 1M k=3, k=16 and k=5 (a k that is not a template
   parameter), at 10000 x 1M k=3, and at small m: 1, 4, 16, 64 and 136 x
   1M k=16 (the first rows of the k=16 set; 136 rows is the v9 drain's
   full scan in ``chip_smoke.py``, which runs v3) and 64 x 1M k=3; and
   phase 1 through each tree's own ``MXUExpansion`` (its own route and
   staging) on the v9 drain's 640000-row launch over the 1M 16-D refs (the
   queries ``chip_smoke.py`` draws), at 10000 x 1M k=16, 1024 x 1M k=24
   and k=40, and 1024 x 65536 k=96 and k=128. Phase-1 outputs are held
   bit-equal where both trees run the same kernel (k = 16), else within
   the engine's delta, ids equal where the runner-up is more than 2 delta
   away (the tensor cores sum in their own order);
3. cases that only this tree runs, timed in this tree's two turns and
   labelled so: v5 at 1024 x 65536 k=128 (v5 before its ring design ran
   out of shared memory from k = 56 and raised) and v7 at 64 x 65536
   k=4096; the other tree's turns print whether its v7 raises there.

It fails without a card, or when the two trees' outputs differ.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

SOURCES = ("cell_scan.cu", "fused_queries_resident.cu", "fused_streaming.cu",
           "fused_point_major.cu", "two_level.cu")
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
_TURNS = ("parent", "this tree", "this tree", "parent")


def _ptxas(_cuda, csrc: str, tag: str) -> None:
    for name in SOURCES:
        with tempfile.TemporaryDirectory(dir=_cuda._BUILD_DIR) as tmp:
            out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                  os.path.join(csrc, name), "-o", os.path.join(tmp, "k.o")],
                                 capture_output=True, text=True, check=True, timeout=600)
        kernel = None
        for line in (out.stdout + out.stderr).splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                inst = re.search(r"\d+([a-z_]+_kernel)(I.*E)?", mangled)
                args = re.findall(r"L[ib](\d+)E", inst.group(2) or "")
                kernel = f"{inst.group(1)}<{', '.join(args)}>" if args else inst.group(1)
            elif kernel and any(w in line for w in ("registers", "spill")):
                print(f"[ptxas] {tag} {name} {kernel}: {line.split(':', 1)[-1].strip()}",
                      flush=True)


def _measure(out: str, this_tree: bool) -> None:
    """One turn: time the kernels of the tree that ``nns_tpu_torch`` imports
    from (this process's PYTHONPATH) and save times and outputs to ``out``;
    with ``this_tree`` also the cases only this tree runs."""
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import fused_ladder
    from nns_tpu_torch.kernels.cell_list import CellListEngine, cell_scan
    from nns_tpu_torch.kernels.fused import prepare_refs

    # This tree's timing, whichever tree is measured: one yardstick for both.
    spec = importlib.util.spec_from_file_location("_report_timing",
                                                  os.path.join(_HERE, "timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    dev = torch.device("cuda")
    rows, outputs = [], []

    def timed(name, bound, detail, fn, *args, delta=None):
        ms, got = timing.cuda_ms(fn, *args)
        device_ms, _ = timing.cuda_device_ms(fn, *args)
        rows.append({"name": name, "ms": ms, "device_ms": device_ms, "bound": bound,
                     "detail": detail, "delta": delta})
        outputs.append([t.cpu() for t in got])

    # cell_scan: one uniform 10K batch and a skewed one (chip_smoke's).
    queries, refs = make_dataset(3, 10_000, 1_000_000, 1000)
    cells = CellListEngine(refs, device=dev)
    skew = queries.copy()
    skew[:600] = (np.float32(0.51) + np.random.default_rng(1000).random(
        (600, 3), dtype=np.float32) * np.float32(0.01))
    for tag, qb in (("one 10K batch", queries), ("skewed 10K batch", skew)):
        packed, _, q_max = cells.stage(qb)
        dense = torch.as_tensor(cells._dense_scatter(packed, q_max)[0], device=dev)
        g, qm = dense.shape[:2]
        timed(f"cell_scan {tag} (G={g}, QM={qm}, R_max={cells.R_max})",
              ("cell", g, qm, cells.R_max, len(qb), cells.avg_candidates), "",
              cell_scan, dense, cells.halo_dm, cells.halo_ids_dev, cells.halo2)
    del cells

    # v6, v3 and v5 at the ladder's shapes, at a run-time k and at 10000
    # rows; the plan each tree prints is its own, where it has one.
    plans = {"fused_queries_resident": lambda m, k: fused_ladder.qres_launch_shape(m, k, dev),
             "fused_point_major": lambda m, k: fused_ladder.ring_launch_shape(
                 "point_major", m, k, dev),
             "fused_streaming": lambda m, k: fused_ladder.ring_launch_shape(
                 "dim_major", m, k, dev),
             "two_level": lambda m, k: fused_ladder.two_level_launch_shape(m, k, dev)}
    q16, r16 = make_dataset(16, 1024, 1_000_000, 1000)
    cases = [("1024 x 1M k=3", (queries[:1024], refs)),
             ("1024 x 1M k=16", (q16, r16)),
             ("1024 x 1M k=5", make_dataset(5, 1024, 1_000_000, 1000)),
             ("10000 x 1M k=3", (queries, refs)),
             *((f"{m} x 1M k=16", (q16[:m], r16)) for m in (1, 4, 16, 64, 136)),
             ("64 x 1M k=3", (queries[:64], refs))]
    for name in ("fused_queries_resident", "fused_point_major", "fused_streaming", "two_level"):
        wrapper = getattr(fused_ladder, f"{name}_min_idx")
        for tag, (q, r) in cases:
            (m, k), n = q.shape, r.shape[0]
            try:
                detail = str(plans[name](m, k))
            except AttributeError:  # a tree without this plan function
                detail = ""
            refs_dev = (torch.as_tensor(r, device=dev) if name == "fused_point_major"
                        else prepare_refs(r, 4096, dev)[0])
            timed(f"{name} {tag}", ("fused", m, n, k), detail, wrapper,
                  torch.as_tensor(q, device=dev), refs_dev, n)
            del refs_dev
    del q16, r16
    _phase1_cases(dev, timed)
    q, r = make_dataset(4096, 64, 65536, 1000)
    q4k, r4k = torch.as_tensor(q, device=dev), prepare_refs(r, 4096, dev)[0]
    if this_tree:
        q, r = make_dataset(128, 1024, 65536, 1000)
        timed("fused_streaming 1024 x 65536 k=128 (this tree only)", ("fused", 1024, 65536, 128),
              str(plans["fused_streaming"](1024, 128)), fused_ladder.fused_streaming_min_idx,
              torch.as_tensor(q, device=dev), prepare_refs(r, 4096, dev)[0], 65536)
        timed("two_level 64 x 65536 k=4096 (this tree only)", ("fused", 64, 65536, 4096),
              str(plans["two_level"](64, 4096)), fused_ladder.two_level_min_idx, q4k, r4k, 65536)
    else:
        try:
            fused_ladder.two_level_min_idx(q4k, r4k, 65536)
            torch.cuda.synchronize()
            print("[probe] the other tree's two_level at 64 x 65536 k=4096: ran", flush=True)
        except RuntimeError as e:
            print(f"[probe] the other tree's two_level at 64 x 65536 k=4096: raised {e}",
                  flush=True)
    torch.save({"rows": rows, "outputs": outputs}, out)


def _phase1_cases(dev, timed) -> None:
    """v9 phase 1 through the measured tree's own engine: its route, its
    staging (rc or rc_t) and ``phase1``."""
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import mxu_expansion as mxe

    q16, r16 = make_dataset(16, 10_000, 1_000_000, 1000)
    rng = np.random.default_rng(1001)  # chip_smoke.py's 63 further batches
    drain = np.concatenate([q16] + [rng.random((10_000, 16), dtype=np.float32)
                                    for _ in range(63)])
    cases = [("640000 x 1M k=16 (the v9 drain's launch)", lambda: (drain, r16)),
             ("10000 x 1M k=16", lambda: (q16, r16)),
             ("1024 x 1M k=24", lambda: make_dataset(24, 1024, 1_000_000, 1000)),
             ("1024 x 1M k=40", lambda: make_dataset(40, 1024, 1_000_000, 1000)),
             ("1024 x 65536 k=96", lambda: make_dataset(96, 1024, 65536, 1000)),
             ("1024 x 65536 k=128", lambda: make_dataset(128, 1024, 65536, 1000))]
    eng = None
    for tag, make in cases:
        q, r = make()
        if eng is None or eng.refs is not r:
            eng = None  # free the last engine's device arrays first
            eng = mxe.MXUExpansion(r, device=dev)
        st = eng.stage_queries(q)
        args = (mxe._cat_q(*mxe.split_bf16x3(st.q_dev)), eng.rc, eng.r2h, eng.tile_n, eng.ts)
        plan = getattr(mxe, "phase1_plan", None)
        detail = f"route {eng.route}" + (f", {plan(eng.kp, eng.ts, 232448)}" if plan else "")
        timed(f"expansion_phase1 {tag}", ("phase1", q.shape[0], r.shape[0], eng.kp), detail,
              lambda: mxe.phase1(*args, rc_t=eng.rc_t),
              delta=None if eng.k == 16 else st.delta)
        del st, args


def _bound(spec) -> tuple[float, str]:
    from nns_tpu_torch.utils.bounds import cell_bound, fused_bound, phase1_bound

    return {"cell": cell_bound, "fused": fused_bound, "phase1": phase1_bound}[spec[0]](*spec[1:])


def _agree(a, b, delta) -> bool:
    """Two outputs agree: bit-equal, or for phase 1 with ``delta``, the
    values (min1, m2x, t2v, t3v) within delta, tid equal where a's m2x is
    more than 2 delta above its min1, tid2 where a's second tile is more
    than 2 delta from its first and third."""
    if delta is None:
        return all(torch.equal(x, y) for x, y in zip(a, b))
    (a1, at, am2, a2, ai2, a3), (b1, bt, bm2, b2, bi2, b3) = a, b
    for x, y in ((a1, b1), (am2, bm2), (a2, b2), (a3, b3)):
        fin = torch.isfinite(x)
        if not torch.equal(fin, torch.isfinite(y)):
            return False
        if fin.any() and float((x[fin].double() - y[fin].double()).abs().max()) > delta:
            return False
    sep = (am2 - a1) > 2 * delta
    sep2 = ((a2 - a1) > 2 * delta) & ((a3 - a2) > 2 * delta)
    return torch.equal(at[sep], bt[sep]) and torch.equal(ai2[sep2], bi2[sep2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the tree to compare with")
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # one turn's output file
    ap.add_argument("--this-tree", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_report: no CUDA device visible", file=sys.stderr)
        return 1
    if args.measure:
        _measure(args.measure, args.this_tree)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    from nns_tpu_torch.kernels import _cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = os.path.abspath(args.parent)
    os.makedirs(_cuda._BUILD_DIR, exist_ok=True)
    _ptxas(_cuda, _cuda._CSRC, "this tree")
    _ptxas(_cuda, os.path.join(parent, "nns_tpu_torch", "csrc"), "parent")
    turns = []
    with tempfile.TemporaryDirectory(dir=_cuda._BUILD_DIR) as tmp:
        for i, tag in enumerate(_TURNS):
            root = parent if tag == "parent" else _ROOT
            out = os.path.join(tmp, f"turn{i}.pt")
            flags = [] if tag == "parent" else ["--this-tree"]
            subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", out, *flags],
                           cwd=root, env={**os.environ, "PYTHONPATH": root}, check=True,
                           timeout=1200)
            turns.append(torch.load(out))
    p1, n1, n2, p2 = turns
    shared = len(p1["rows"])
    for j, row in enumerate(n1["rows"][shared:], shared):  # this tree alone
        print(f"[time] {row['name']}: cuda_ms {row['ms']:.4f} / {n2['rows'][j]['ms']:.4f} ms, "
              f"cuda_device_ms {row['device_ms']:.4f} / {n2['rows'][j]['device_ms']:.4f} ms; "
              f"bound {_bound(row['bound'])[0]:.4f} ms ({_bound(row['bound'])[1]}); "
              f"plan {row['detail']}", flush=True)
        if not all(torch.equal(a, b) for a, b in zip(n1["outputs"][j], n2["outputs"][j])):
            raise AssertionError(f"this tree's two turns disagree on {row['name']}")
    for j, row in enumerate(n1["rows"][:shared]):
        if not all(t["rows"][j]["name"] == row["name"] for t in turns):
            raise AssertionError(f"the turns measured different cases at {row['name']}")
        if not _agree(p1["outputs"][j], n1["outputs"][j], row["delta"]):
            raise AssertionError(f"the two trees' kernels disagree on {row['name']}")
        bound_ms, bound_by = _bound(row["bound"])
        for key, what in (("ms", "cuda_ms"), ("device_ms", "cuda_device_ms")):
            old = (p1["rows"][j][key] + p2["rows"][j][key]) / 2
            new = (row[key] + n2["rows"][j][key]) / 2
            print(f"[time] {row['name']}, {what}: parent {p1['rows'][j][key]:.4f} / "
                  f"{p2['rows'][j][key]:.4f} ms, this tree {row[key]:.4f} / "
                  f"{n2['rows'][j][key]:.4f} ms (in turns); bound {bound_ms:.4f} ms "
                  f"({bound_by}); share of bound parent {bound_ms / old:.1%}, this tree "
                  f"{bound_ms / new:.1%}; speed-up {old / new:.2f}x; outputs "
                  f"{'bit-equal' if row['delta'] is None else 'within delta'}",
                  flush=True)
        if row["detail"]:
            print(f"[plan] {row['name']}: this tree {row['detail']}", flush=True)
    return 0


if __name__ == "__main__":
    if "--measure" in sys.argv:
        # Run as a file for one turn: import the measured tree's package from
        # PYTHONPATH, never from this file's directory.
        sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
    sys.exit(main())
