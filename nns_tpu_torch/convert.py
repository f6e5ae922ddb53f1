"""State carried across from the JAX package.

In this system the "weights" are index state. These functions turn a JAX
engine's state, given as numpy arrays, into port objects on ``device``
without rebuilding anything, so the two packages can be compared slot by
slot on the same index. The brute-force rungs v0-v3 and v5-v7 hold no
state beyond the refs, so they need no function here.
"""

from __future__ import annotations

import numpy as np
import torch

from nns_tpu_torch.kernels.cell_list import CellListEngine
from nns_tpu_torch.kernels.fused import FusedBruteForce
from nns_tpu_torch.kernels.layouts import PAD_SENTINEL
from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion

CELL_STATE_KEYS = ("refs", "halo_dm", "halo_ids", "mn", "W", "halo", "D", "R_max")
MXU_STATE_KEYS = ("refs", "rc", "r2h", "refs_t", "r2h_t", "tile_n", "ts")


def cell_engine_from_numpy(state: dict, device="cuda") -> CellListEngine:
    """A CellListEngine over a JAX ``CellListEngine``'s state: ``refs``
    (n, 3) f32, ``halo_dm`` (G, 3, R_max) f32, ``halo_ids`` (G, R_max) i32,
    ``mn`` and ``W`` (3,) f64, ``halo`` float, ``D`` and ``R_max`` ints."""
    missing = [k for k in CELL_STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"cell engine state lacks {missing}")
    # Copies: the JAX arrays are read-only, and a CPU-device engine shares
    # memory with what it is given.
    halo_dm = np.array(state["halo_dm"], dtype=np.float32, order="C")
    halo_ids = np.array(state["halo_ids"], dtype=np.int32, order="C")
    D, r_max = int(state["D"]), int(state["R_max"])
    if halo_dm.shape != (D ** 3, 3, r_max) or halo_ids.shape != (D ** 3, r_max):
        raise ValueError(
            f"halo shapes {halo_dm.shape}, {halo_ids.shape} do not match "
            f"D={D}, R_max={r_max}")
    eng = CellListEngine.__new__(CellListEngine)
    eng.refs = np.array(state["refs"], dtype=np.float32, order="C")
    eng.n = eng.refs.shape[0]
    eng.D, eng.R_max = D, r_max
    eng.mn = np.asarray(state["mn"], dtype=np.float64)
    eng.W = np.asarray(state["W"], dtype=np.float64)
    eng.halo = float(state["halo"])
    eng.avg_candidates = float((halo_dm[:, 0, :] < PAD_SENTINEL).sum() / D ** 3)
    eng._place(halo_dm, halo_ids, device)
    return eng


def fused_from_numpy(refs: np.ndarray, tile_n: int = 4096, device="cuda") -> FusedBruteForce:
    """A FusedBruteForce whose dim-major replica-padded refs equal the JAX
    ``FusedBruteForce(refs, tile_n=tile_n).r_dm``."""
    return FusedBruteForce(np.ascontiguousarray(refs, dtype=np.float32), tile_n=tile_n,
                           device=device)


def _bf16(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy array of bf16 values as a bf16 tensor: 2-byte items (the JAX
    array's own bfloat16 dtype) are taken bit for bit, wider ones cast."""
    if arr.dtype.itemsize == 2:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.asarray(arr, dtype=np.float32)).to(torch.bfloat16).to(device)


def mxu_engine_from_numpy(state: dict, device="cuda") -> MXUExpansion:
    """An MXUExpansion over a JAX ``MXUExpansion``'s staged arrays: ``refs``
    (n, k) f32, ``rc`` (3 kp, n_pad) bf16, ``r2h`` (1, n_pad) f32,
    ``refs_t`` (n_sub, ts, kp) f32, ``r2h_t`` (n_sub, ts) f32, and the ints
    ``tile_n``, ``ts``."""
    missing = [k for k in MXU_STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"expansion engine state lacks {missing}")
    # Copies: the JAX arrays are read-only, and a CPU-device engine shares
    # memory with what it is given.
    f32 = {k: torch.from_numpy(np.array(state[k], dtype=np.float32, order="C"))
           for k in ("r2h", "refs_t", "r2h_t")}
    return MXUExpansion.from_staged(
        state["refs"], _bf16(np.asarray(state["rc"]), "cpu"), f32["r2h"], f32["refs_t"],
        f32["r2h_t"], int(state["tile_n"]), int(state["ts"]), device=device)
