"""Build + ctypes loader for the native C++ host library.

The source is the JAX package's ``nns_tpu/native/nns_cpu.cpp``, compiled
BY FILE PATH with the same g++ line as ``nns_tpu/native/build.py``: importing
``nns_tpu.native`` would run ``nns_tpu/__init__.py``, which imports jax. The
library goes into the git-ignored ``nns_tpu_torch/_build/``. Public wrappers
return None when the library cannot be built, and callers fall back to numpy
(the same contract as the JAX package).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "nns_tpu", "native", "nns_cpu.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB = os.path.join(_BUILD_DIR, "libnns_cpu.so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def ensure_built() -> bool:
    """Compile nns_cpu.cpp -> _build/libnns_cpu.so if missing or older than
    the source. True on success. The compiler writes a per-process temporary
    that is renamed into place, so concurrent test workers never load a
    half-written library."""
    if not os.path.exists(_SRC):
        return False
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return True
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError):
        return False
    os.replace(tmp, _LIB)
    return True


def load_library() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not ensure_built():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.nns_linear_scan.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p, i32p,
        ]
        lib.nns_linear_scan.restype = None
        lib.nns_cells_count.argtypes = [
            ctypes.c_int, f32p, ctypes.c_int, ctypes.c_double, f64p, f64p, i32p,
        ]
        lib.nns_cells_count.restype = ctypes.c_int
        lib.nns_cells_fill.argtypes = [
            ctypes.c_int, f32p, ctypes.c_int, ctypes.c_double, f64p, f64p,
            ctypes.c_int, f32p, i32p,
        ]
        lib.nns_cells_fill.restype = ctypes.c_int
        lib.nns_cells_stage.argtypes = [
            ctypes.c_int, f32p, ctypes.c_int, f64p, f64p, f32p, i32p,
        ]
        lib.nns_cells_stage.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def native_linear_scan(queries: np.ndarray, refs: np.ndarray) -> np.ndarray | None:
    """OpenMP f32 linear scan (v0). Returns None when the lib is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    q = np.ascontiguousarray(queries, dtype=np.float32)
    r = np.ascontiguousarray(refs, dtype=np.float32)
    m, k = q.shape
    n = r.shape[0]
    out = np.empty(m, dtype=np.int32)
    lib.nns_linear_scan(k, m, n, q, r, out)
    return out


def native_cells_build(refs: np.ndarray, d_per_dim: int, halo: float,
                       mn: np.ndarray, w: np.ndarray, r_cap: int,
                       sentinel: float):
    """Two-pass supercell halo build. Returns (halo_dm (G, 3, R_max) —
    dim-major, device-ready — halo_ids, counts); (None, None, counts) on
    r_cap overflow; None when the native lib is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    r = np.ascontiguousarray(refs, dtype=np.float32)
    n = r.shape[0]
    G = d_per_dim ** 3
    mn = np.ascontiguousarray(mn, dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    counts = np.empty(G, dtype=np.int32)
    lib.nns_cells_count(n, r, d_per_dim, float(halo), mn, w, counts)
    r_max = int(counts.max()) if G else 0
    if r_max > r_cap:
        return None, None, counts  # overflow: caller raises like numpy path
    # Round to 256 slots, not pow2: the scan pays R_max for every group.
    size = max(256, -(-r_max // 256) * 256)
    halo_dm = np.full((G, 3, size), sentinel, dtype=np.float32)
    halo_ids = np.zeros((G, size), dtype=np.int32)
    ok = lib.nns_cells_fill(
        n, r, d_per_dim, float(halo), mn, w, size,
        halo_dm.reshape(-1), halo_ids.reshape(-1),
    )
    if ok != 0:
        return None
    return halo_dm, halo_ids, counts


def native_cells_stage(queries: np.ndarray, d_per_dim: int,
                       mn: np.ndarray, w: np.ndarray):
    """Counting-sort query staging. Returns (packed (m,5) f32, order, q_max)
    or None when the lib is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    q = np.ascontiguousarray(queries, dtype=np.float32)
    m = q.shape[0]
    packed = np.empty((m, 5), dtype=np.float32)
    order = np.empty(m, dtype=np.int32)
    q_max = lib.nns_cells_stage(
        m, q, d_per_dim,
        np.ascontiguousarray(mn, dtype=np.float64),
        np.ascontiguousarray(w, dtype=np.float64),
        packed.reshape(-1), order,
    )
    return packed, order.astype(np.int64), int(q_max)
