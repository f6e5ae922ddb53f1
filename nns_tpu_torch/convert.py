"""State carried across from the JAX package.

In this system the "weights" are index state. These functions turn a JAX
engine's state, given as numpy arrays, into port objects on ``device``
without rebuilding anything, so the two packages can be compared slot by
slot on the same index. The brute-force rungs v0-v3 and v5-v7 hold no
state beyond the refs, so they need no function here.
"""

from __future__ import annotations

import numpy as np

from nns_tpu_torch.kernels.cell_list import CellListEngine
from nns_tpu_torch.kernels.fused import FusedBruteForce
from nns_tpu_torch.kernels.layouts import PAD_SENTINEL

CELL_STATE_KEYS = ("refs", "halo_dm", "halo_ids", "mn", "W", "halo", "D", "R_max")


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
