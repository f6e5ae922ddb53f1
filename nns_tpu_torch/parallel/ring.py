"""Ring-sharded exact 1-NN, the blockwise / ring-attention layout.
Counterpart of ``nns_tpu/parallel/ring.py``.

``sharded.py`` replicates the queries and gathers each device's winners.
Here both sides are sharded over the mesh's first axis: device i holds
query block i (m/D rows) and, at step s, reference block (i + s) mod D,
which it scores with the v4 kernel and folds into its carried
(min_d2, global idx) by the same lexicographic fold as ``sharded.py``
(``fold_min_idx``), so the lowest global index wins whatever order the
blocks visit in. Between steps every block moves one hop, from device j to
device j - 1 (``Tensor.to``, a peer copy between GPUs; nothing on a
repeated device). Per device that is O(m/D + n/D) memory, and the refs are
never held whole on one device.
"""

from __future__ import annotations

import torch

from nns_tpu_torch.kernels import layouts
from nns_tpu_torch.kernels.fused import as_f32, fused_min_idx, nns_fused
from nns_tpu_torch.parallel.mesh import Mesh, best_mesh
from nns_tpu_torch.parallel.sharded import dim_major_blocks, fold_min_idx


def ring_argmin(queries, refs, mesh: Mesh) -> torch.Tensor:
    """Exact 1-NN indices (m,) i32 on ``mesh.devices[0]``, queries and refs
    both sharded over the mesh's first axis (on a 2-D mesh, the first
    device of each row). The queries are zero-padded to D * 8 rows, the refs
    replica-padded to D * 128 columns."""
    n_dev = mesh.shape[0]
    devices = mesh.devices[::mesh.size // n_dev]
    m = queries.shape[0]
    q = layouts.pad_queries(as_f32(queries, "cpu"), n_dev * 8)
    m_l = q.shape[0] // n_dev
    blocks, shard_n = dim_major_blocks(as_f32(refs, "cpu"), n_dev)
    q_loc = [q[i * m_l:(i + 1) * m_l].to(dev) for i, dev in enumerate(devices)]
    cur = [b.to(dev) for b, dev in zip(blocks, devices)]  # cur[i]: block (i + s) mod D
    best = []
    for s in range(n_dev):
        for i in range(n_dev):
            d, li = fused_min_idx(q_loc[i], cur[i], shard_n)
            gi = li + ((i + s) % n_dev) * shard_n
            if s == 0:
                best.append((d, gi))
            else:
                best[i] = fold_min_idx(*best[i], d, gi)
        if s + 1 < n_dev:  # one hop: device i takes the block of device i + 1
            cur = [cur[(i + 1) % n_dev].to(dev, non_blocking=True)
                   for i, dev in enumerate(devices)]
    return torch.cat([i.to(devices[0]) for _, i in best])[:m]


def nns_ring(queries, refs, mesh: Mesh | None = None, device="cuda") -> torch.Tensor:
    """``ring_argmin`` over ``mesh`` (default: ``best_mesh`` of ``device``'s
    type); one device runs the single-device v4 path."""
    if mesh is None:
        mesh = best_mesh(refs.shape[0], device=device)
    if mesh.size == 1:
        return nns_fused(queries, refs, device=mesh.devices[0])
    return ring_argmin(queries, refs, mesh)
