"""What the v9 phase-1 kernels compile to, and how their chunk widths time.

Run from the repository root on a machine with one CUDA device:
``python -m nns_tpu_torch.utils.phase1_report``. It prints the card's name
and power limit, then

1. ptxas's registers and spills for each kernel of
   ``csrc/expansion_phase1.cu`` (``nvcc -Xptxas -v`` with the package's
   flags);
2. the count of ``HGMMA`` instructions in each phase-1 kernel of the
   package's library (``cuobjdump -sass``); it fails when the wgmma kernel
   has none;
3. over bench_k16's 1M 16-D refs (seed 1000) and 10000 uniform 16-D
   queries (seed 1001), the times (CUDA events, median of 5) of the wgmma
   kernel with 128-column chunks (ts = 256, the engine's), the same kernel
   with 64-column chunks (ts = 64) and ``phase1_kernel`` (mma.sync) at ts =
   256, each through its own entry point, in that order and again reversed.
   ts = 64 closes a subtile after every chunk, so its epilogue does a little
   more work; the products are the same.

It fails without a card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch


def _kernel_name(mangled: str) -> str:
    wg = re.search(r"phase1_wgmma_kernelILi(\d+)ELi(\d+)E", mangled)
    if wg:
        return f"phase1_wgmma_kernel<{wg.group(1)}, {wg.group(2)}>"
    for name in ("phase1_merge_kernel", "phase1_kernel"):
        if name in mangled:
            return name
    return mangled


def _ptxas(_cuda) -> None:
    src = os.path.join(_cuda._CSRC, "expansion_phase1.cu")
    with tempfile.TemporaryDirectory(dir=_cuda._BUILD_DIR) as tmp:
        out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", src,
                              "-o", os.path.join(tmp, "p1.o")],
                             capture_output=True, text=True, check=True, timeout=600)
    kernel = None
    for line in (out.stdout + out.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line.split("'")[1])
        elif kernel and any(w in line for w in ("registers", "spill")):
            print(f"[ptxas] {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)


def _sass(_cuda) -> None:
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _cuda.build()], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = _kernel_name(head.group(1)) if "phase1" in head.group(1) else None
            if fn:
                counts.setdefault(fn, 0)
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    for name, count in sorted(counts.items()):
        print(f"[sass] {name}: {count} HGMMA instructions", flush=True)
    if not any(c for name, c in counts.items() if name.startswith("phase1_wgmma_kernel")):
        raise RuntimeError("no HGMMA instruction in phase1_wgmma_kernel's SASS")


def main() -> int:
    if not torch.cuda.is_available():
        print("phase1_report: no CUDA device visible", file=sys.stderr)
        return 1
    from nns_tpu_torch.data import make_dataset
    from nns_tpu_torch.kernels import _cuda
    from nns_tpu_torch.kernels.mxu_expansion import (
        MXUExpansion, _cat_q, _phase1_cuda, split_bf16x3)
    from nns_tpu_torch.utils.timing import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _cuda.library()
    _ptxas(_cuda)
    _sass(_cuda)
    _, refs = make_dataset(16, 1, 1_000_000, 1000)
    mx = MXUExpansion(refs, device="cuda")
    if mx.route != "wgmma" or mx.ts != 256:
        raise RuntimeError(f"expected the wgmma route at ts = 256, got {mx.route}, ts={mx.ts}")
    q = np.random.default_rng(1001).random((10_000, 16), dtype=np.float32)
    qc = _cat_q(*split_bf16x3(mx.stage_queries(q).q_dev))
    rc = mx.rc.contiguous()
    runs = {
        "wgmma, 128-column chunks (ts = 256)":
            lambda: _phase1_cuda(qc, rc, mx.r2h, mx.tile_n, 256, mx.rc_t, "wgmma"),
        "wgmma, 64-column chunks (ts = 64)":
            lambda: _phase1_cuda(qc, rc, mx.r2h, mx.tile_n, 64, mx.rc_t, "wgmma"),
        "mma.sync phase1_kernel (ts = 256)":
            lambda: _phase1_cuda(qc, rc, mx.r2h, mx.tile_n, 256, mx.rc_t, "mma_sync"),
    }
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(cuda_ms(runs[name])[0])
    for name, (first, second) in times.items():
        print(f"[time] 10000 x 1M k=16 {name}: {first:.4f} / {second:.4f} ms "
              f"(in order / reversed)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
