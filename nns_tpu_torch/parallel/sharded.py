"""Refs sharded over a device mesh: v8, the multi-GPU brute force
(core.cu:700-1058). Counterpart of ``nns_tpu/parallel/sharded.py``.

The reference shards the refs contiguously over its GPUs (thread_n =
divup(n, num_gpus), core.cu:781), replicates the queries to every GPU
(:793), runs its fused kernel per GPU, rebases each local index by its
shard's offset (:1032-1033) and merges on the host (:821-852).

The port keeps that decomposition on a single-controller ``Mesh``. The refs
are replica-padded to a multiple of n_shard * 128 (``layouts.pad_refs``:
padding columns copy refs[0], sit at indices >= n and lose every tie) and
staged once per shard as a contiguous dim-major (k, shard_n) tensor on that
shard's device, so that a query copies no ref. Each shard runs the v4
kernel (``fused_min_idx``) on its block and adds ``shard * shard_n``. The
(min_d2, global idx) winners go to ``devices[0]`` by ``Tensor.to`` (a peer
copy between GPUs, which PyTorch orders after the launches that made them;
nothing on a repeated device) and are folded lexicographically on
(d2, idx) by ``fold_min_idx``, so the lowest global index wins among equal
distances in whatever order the shards come. The merge is a few torch ops
on (D, m) values, as it is XLA glue in the JAX package.
"""

from __future__ import annotations

import torch

from nns_tpu_torch.kernels import layouts
from nns_tpu_torch.kernels.fused import as_f32, fused_min_idx, nns_fused
from nns_tpu_torch.parallel.mesh import Mesh, best_mesh

_LANE = 128


def fold_min_idx(best_d: torch.Tensor, best_i: torch.Tensor, d: torch.Tensor,
                 i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row, the (d2, idx) pair that is smaller lexicographically: the
    smaller distance, and the lower index among equal distances."""
    better = (d < best_d) | ((d == best_d) & (i < best_i))
    return torch.where(better, d, best_d), torch.where(better, i, best_i)


def merge_winners(parts, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold (min_d2, global idx) pairs that lie on any devices, on ``device``."""
    best_d, best_i = (t.to(device) for t in parts[0])
    for d, i in parts[1:]:
        best_d, best_i = fold_min_idx(best_d, best_i, d.to(device), i.to(device))
    return best_d, best_i


def dim_major_blocks(refs: torch.Tensor, n_blocks: int) -> tuple[list[torch.Tensor], int]:
    """(n, k) refs replica-padded to a multiple of n_blocks * 128 and cut
    into n_blocks contiguous dim-major (k, shard_n) blocks on their device.
    Returns (blocks, shard_n)."""
    r = layouts.pad_refs(refs, n_blocks * _LANE)
    shard_n = r.shape[0] // n_blocks
    return [layouts.to_dim_major(r[j * shard_n:(j + 1) * shard_n])
            for j in range(n_blocks)], shard_n


class ShardedBruteForce:
    """Prepare-once / query-many v8 on ``mesh``. A 1-D mesh shards the refs
    over all its devices and replicates the queries; a 2-D (n_dp, n_shard)
    mesh also splits the queries into n_dp row blocks (data parallel, zero
    padded to n_dp * 8 rows) and shards the refs over its second axis, so
    that the merge of each row block runs over the shard axis only. Each
    (device, shard) block is staged once, however often the mesh repeats it."""

    def __init__(self, refs, mesh: Mesh):
        self.mesh = mesh
        self.n_dp, self.n_shard = (1, mesh.size) if len(mesh.shape) == 1 else mesh.shape
        r = as_f32(refs, "cpu")
        self.n = r.shape[0]
        # Cut on the host, so that each device receives its own blocks only.
        host, self.shard_n = dim_major_blocks(r, self.n_shard)
        staged: dict[tuple[torch.device, int], torch.Tensor] = {}
        self.blocks = []
        for p, dev in enumerate(mesh.devices):
            key = (dev, p % self.n_shard)
            if key not in staged:
                staged[key] = host[key[1]].to(dev)
            self.blocks.append(staged[key])

    def query_min_idx(self, queries) -> tuple[torch.Tensor, torch.Tensor]:
        """(min_d2 (m,) f32, global idx (m,) i32) on ``devices[0]``."""
        dev0 = self.mesh.devices[0]
        q = as_f32(queries, dev0)
        m = q.shape[0]
        if self.n_dp > 1:
            q = layouts.pad_queries(q, self.n_dp * 8)
        m_l = q.shape[0] // self.n_dp
        out_d, out_i = [], []
        for row in range(self.n_dp):
            q_row, replicas, parts = q[row * m_l:(row + 1) * m_l], {}, []
            for j in range(self.n_shard):
                p = row * self.n_shard + j
                dev = self.mesh.devices[p]
                if dev not in replicas:
                    replicas[dev] = q_row.to(dev)
                d, i = fused_min_idx(replicas[dev], self.blocks[p], self.shard_n)
                parts.append((d, i + j * self.shard_n))
            d, i = merge_winners(parts, dev0)
            out_d.append(d)
            out_i.append(i)
        return torch.cat(out_d)[:m], torch.cat(out_i)[:m]

    def query(self, queries) -> torch.Tensor:
        return self.query_min_idx(queries)[1]


def sharded_argmin(queries, refs, mesh: Mesh) -> torch.Tensor:
    """Exact 1-NN indices (m,) i32 on ``mesh.devices[0]``, the refs sharded
    over a 1-D mesh and the queries replicated."""
    if len(mesh.shape) != 1:
        raise ValueError(f"sharded_argmin takes a 1-D mesh, not shape {mesh.shape}")
    return ShardedBruteForce(refs, mesh).query(queries)


def sharded_argmin_2d(queries, refs, mesh: Mesh) -> torch.Tensor:
    """Exact 1-NN over a 2-D (n_dp, n_shard) mesh: queries data-parallel
    over the first axis, the refs sharded over the second (the merge rides
    the shard axis only)."""
    if len(mesh.shape) != 2:
        raise ValueError(f"sharded_argmin_2d takes a 2-D mesh, not shape {mesh.shape}")
    return ShardedBruteForce(refs, mesh).query(queries)


def nns_sharded(queries, refs, mesh: Mesh | None = None, device="cuda") -> torch.Tensor:
    """v8: ``sharded_argmin`` over ``mesh`` (default: ``best_mesh`` of
    ``device``'s type). One device runs the single-device v4 path (the
    reference's fallback contract, core.cu:774-777)."""
    if mesh is None:
        mesh = best_mesh(refs.shape[0], device=device)
    if mesh.size == 1:
        return nns_fused(queries, refs, device=mesh.devices[0])
    return sharded_argmin(queries, refs, mesh)
