"""Build and bind the hand-written CUDA kernels in ``nns_tpu_torch/csrc/``.

nvcc compiles every ``csrc/*.cu`` (one nvcc process per source, all started
together) and links the objects into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), for ``sm_90a``
and with ``-fmad=false``: the kernels' distances must round exactly like
their plain PyTorch versions, which never fuse a multiply into an add. The
library goes into the git-ignored ``nns_tpu_torch/_build/`` at first use and
is rebuilt when a source is newer. ctypes passes every pointer and the
stream as ``c_void_p``; each C entry point returns ``cudaGetLastError()``
after its launches and ``check`` raises on anything but 0.

Nothing here falls back: a missing nvcc or a failed build raises
RuntimeError. Only the kernel wrappers touch this module, and only for CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB = os.path.join(_BUILD_DIR, "libnns_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# Launch counts per kernel wrapper: each wrapper adds one right after its
# kernel launch succeeds, and nowhere else. The plain CPU path never counts.
LAUNCHES: dict[str, int] = {
    "fused_argmin": 0, "cell_scan": 0, "cell_bin": 0, "cell_place": 0, "cell_answer": 0,
    "fused_point_major": 0, "fused_streaming": 0, "fused_queries_resident": 0, "two_level": 0,
    "expansion_phase1": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources(pattern: str = "*.cu") -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, pattern)))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (no CUDA toolkit): the CUDA kernels of "
            "nns_tpu_torch cannot be built"
        )
    return nvcc


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into the kernel library if missing or stale (or
    always, with ``force``). Returns the library path; raises RuntimeError
    with nvcc's output when the build fails."""
    srcs = _sources()
    fresh = os.path.exists(_LIB) and all(
        os.path.getmtime(_LIB) >= os.path.getmtime(s)
        for s in srcs + _sources("*.cuh")
    )
    if fresh and not force:
        return _LIB
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as obj_dir:
        objs = [os.path.join(obj_dir, os.path.basename(s)[:-3] + ".o") for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        failed = []
        try:
            for cmd, proc in zip(cmds, procs):
                out, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        finally:
            for proc in procs:  # none outlives the build, even on a timeout
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, _LIB)
    return _LIB


_vp, _ci, _cf, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# The argument types of the library's C entry points (each returns an int,
# a cudaError_t); a CPU test holds them against the extern "C" definitions
# under csrc/.
SIGNATURES = {
    "nns_fused_argmin": [_vp, _vp, _vp, _ci, _ci, _ci, _cll, _ci, _ci, _ci, _ci, _ci, _ci,
                         _vp, _vp, _vp, _vp, _ci, _vp],
    "nns_fused_argmin_smem": [_ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp],
    "nns_fused_argmin_tensor_map": [_vp, _ci, _ci, _cll, _ci, _ci, _vp],
    "nns_cell_scan": [_vp, _vp, _vp, _ci, _ci, _ci, _cf, _vp, _vp, _vp],
    "nns_cell_bin": [_vp, _vp, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp],
    "nns_cell_place": [_vp, _vp, _ci, _ci, _vp, _vp, _vp, _cll, _vp, _vp, _vp],
    "nns_cell_answer": [_vp, _vp, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
    "nns_fused_point_major":
        [_vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp],
    "nns_fused_point_major_smem": [_ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp],
    "nns_fused_streaming":
        [_vp, _vp, _ci, _ci, _ci, _cll, _ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp],
    "nns_fused_streaming_smem": [_ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp],
    "nns_fused_queries_resident":
        [_vp, _vp, _ci, _ci, _ci, _cll, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp],
    "nns_fused_queries_resident_smem": [_ci, _ci, _ci, _ci, _ci, _vp, _vp],
    "nns_two_level":
        [_vp, _vp, _ci, _ci, _ci, _cll, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp],
    "nns_two_level_smem": [_ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp],
    "nns_expansion_phase1_wgmma":
        [_vp, _vp, _vp, _ci, _ci, _cll, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp],
    "nns_expansion_phase1_wgmma_blocks_per_sm": [_ci, _ci, _vp],
    "nns_smem_optin": [_vp],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Raises RuntimeError
    when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _ci
        lib.nns_cuda_error_string.argtypes = [_ci]
        lib.nns_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def smem_optin(lib: ctypes.CDLL) -> int:
    """The opt-in shared memory per block of the current CUDA device, bytes."""
    optin = ctypes.c_int()
    check(lib, lib.nns_smem_optin(ctypes.byref(optin)), "smem_optin")
    return optin.value


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise RuntimeError when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.nns_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
