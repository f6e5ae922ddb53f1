"""``dryrun_multichip``: the multi-device query steps at tiny shapes.
Counterpart of ``__graft_entry__.py:43-148``.

It runs the 1-D sharded brute force, the 2-D (data-parallel x sharded)
merge, the ring, the sharded supercell engine and its mixed-q_max queue
drain over ``n_devices`` shards of ``device``'s type, and raises if any
differs from another or from the f64 oracle. Where fewer distinct devices
exist it uses a virtual mesh (``Mesh.virtual``), as the JAX package re-runs
itself on virtual CPU devices.
"""

from __future__ import annotations

import numpy as np

from nns_tpu_torch.data import make_dataset
from nns_tpu_torch.kernels.oracle import recall_at_1
from nns_tpu_torch.parallel.mesh import Mesh, _devices, make_mesh
from nns_tpu_torch.parallel.ring import ring_argmin
from nns_tpu_torch.parallel.sharded import sharded_argmin, sharded_argmin_2d
from nns_tpu_torch.parallel.sharded_cells import ShardedCellEngine


def _mesh(shape, device) -> Mesh:
    """Distinct devices where there are enough, else ``device`` repeated."""
    devices = _devices(device)
    n = int(np.prod(shape))
    if len(devices) < n:
        return Mesh.virtual(shape, device)
    if isinstance(shape, int):
        return make_mesh(n, device=device)
    return Mesh(tuple(devices[:n]), tuple(shape))


def _equal(what: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: {int((got != want).sum())} of {want.size} answers differ")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The query steps of the multi-device layer over ``n_devices`` shards;
    raises AssertionError on a wrong answer."""
    queries, refs = make_dataset(k=3, m=64, n=n_devices * 256, seed=1000)
    mesh1 = _mesh(n_devices, device)
    idx1 = sharded_argmin(queries, refs, mesh1).cpu().numpy()
    if idx1.shape != (64,):
        raise AssertionError(f"sharded_argmin gave shape {idx1.shape}")
    if n_devices % 2 == 0:  # queries data-parallel x refs sharded
        mesh2 = _mesh((2, n_devices // 2), device)
        _equal("sharded_argmin_2d", sharded_argmin_2d(queries, refs, mesh2).cpu(), idx1)
    _equal("ring_argmin", ring_argmin(queries, refs, mesh1).cpu(), idx1)

    qc, rc = make_dataset(k=3, m=64, n=16384, seed=1000)
    eng = ShardedCellEngine(rc, mesh1)
    idx3 = eng.query(qc)
    # The serving queue: a W = 8 queue whose two skewed batches take a
    # larger q_max tier than the other six.
    rng = np.random.default_rng(7)
    queue = [rng.random((48, 3), dtype=np.float32) for _ in range(6)]
    for at in (2, 5):
        queue.insert(at, (rng.random((48, 3), dtype=np.float32) * 0.05).astype(np.float32))
    for w, (qb, idx_q) in enumerate(zip(queue, eng.query_queue(queue))):
        _equal(f"queue batch {w}", idx_q, eng.query(qb))

    for what, idx, q, r in (("sharded_argmin", idx1, queries, refs),
                            ("ShardedCellEngine", idx3, qc, rc)):
        rec = recall_at_1(idx, q, r)
        if rec != 1.0:
            raise AssertionError(f"{what}: recall@1 {rec} against the f64 oracle")

