"""Supercell groups sharded over a device mesh: the flagship's multi-device
form. Counterpart of ``nns_tpu/parallel/sharded_cells.py``.

The supercell index shards by groups. The group axis is padded to g_pad, a
multiple of the mesh size, with sentinel-only groups, and group range j
(g_local groups: halo points and ids) lives on ``devices[j]``. A staged
(m, 5) pack is sorted by group, so shard j's rows are one slice of it:
each run of consecutive shards on one device uploads its rows, scatters
them into the dense table of its groups, scans each shard that holds rows
on its own (g_local, QM, 3) slice and gathers the rows' winners; only
those signed winners go to ``devices[0]`` (``Tensor.to``), where they are
concatenated in shard order, which is the staged order. The drain
(``query_queue``) stages every batch on the host, since the shards cut the
sorted pack, downloads once per drain and re-answers the uncertified rows
exactly. Build, staging, the certificate and the exact fallback are
``CellListEngine``'s.
(The JAX package has every shard scatter the whole replicated pack and
all-gathers the (G, QM) winner table; the port moves fewer bytes and gives
the same answers.)

What differs from the single-device engine, as in the JAX package:
``query_collect_dist`` recomputes best_d2 on the host in float64 from the
winning candidate (the shards send ids only), and ``save`` writes the
single-device npz, so one file restores as either engine on any mesh size.
"""

from __future__ import annotations

import numpy as np
import torch

from nns_tpu_torch.kernels.cell_list import (CellListEngine, CellToken, _device_query_topk,
                                             _upload, cell_scan, nns_cell_list)
from nns_tpu_torch.kernels.fused import as_f32
from nns_tpu_torch.kernels.layouts import PAD_SENTINEL, non_finite_error
from nns_tpu_torch.parallel.mesh import Mesh, make_mesh
from nns_tpu_torch.parallel.sharded import nns_sharded
from nns_tpu_torch.utils.spans import count_copy, span


class ShardedCellEngine(CellListEngine):
    """Supercell engine with its halo groups sharded over a 1-D mesh."""

    def __init__(self, refs: np.ndarray, mesh: Mesh, **kwargs):
        self._set_mesh(mesh)
        super().__init__(refs, device=mesh.devices[0], **kwargs)

    def _set_mesh(self, mesh: Mesh) -> None:
        if len(mesh.shape) != 1:
            raise ValueError(f"ShardedCellEngine takes a 1-D mesh, not shape {mesh.shape}")
        self.mesh = mesh
        self.n_dev = mesh.size

    def _place(self, halo_dm_np: np.ndarray, halo_ids: np.ndarray, device) -> None:
        """Pad the group axis to a multiple of the mesh size with
        sentinel-only groups and put group range j on ``devices[j]``."""
        G = self.D ** 3
        self.g_pad = -(-G // self.n_dev) * self.n_dev
        self.g_local = self.g_pad // self.n_dev
        dm, ids = halo_dm_np, halo_ids
        if self.g_pad != G:
            dm = np.concatenate([dm, np.full((self.g_pad - G,) + dm.shape[1:], PAD_SENTINEL,
                                             np.float32)])
            ids = np.concatenate([ids, np.zeros((self.g_pad - G, self.R_max), np.int32)])
        self.device = self.mesh.devices[0]
        self.halo_ids = halo_ids
        self.shards = [
            (dev, torch.as_tensor(dm[j * self.g_local:(j + 1) * self.g_local], device=dev),
             torch.as_tensor(ids[j * self.g_local:(j + 1) * self.g_local], device=dev))
            for j, dev in enumerate(self.mesh.devices)]
        # Runs of consecutive shards on one device: (device, first, last).
        self._runs = []
        for j, dev in enumerate(self.mesh.devices):
            if self._runs and self._runs[-1][0] == dev:
                self._runs[-1] = (dev, self._runs[-1][1], j)
            else:
                self._runs.append((dev, j, j))
        self._fused = None
        self.halo2 = float(np.float32(self.halo) ** 2)

    def _shard_cuts(self, packed: np.ndarray) -> np.ndarray:
        """(n_dev + 1,) row offsets of each shard's slice of a staged pack,
        whose rows are sorted by group."""
        return np.searchsorted(packed[:, 3], np.arange(self.n_dev + 1) * self.g_local)

    def query_staged(self, packed, q_max: int) -> tuple[torch.Tensor, None]:
        """Device half of one batch, sharded (the counterpart of the JAX
        package's ``_build_scan`` local body). The pack is sorted by group,
        so the rows of each run of consecutive shards on one device are one
        slice: the run uploads it, scatters it into the dense table of its
        groups, launches ``cell_scan`` for each of its shards that holds
        rows, and gathers each row's signed winner; only those (m_run,)
        winners go to ``devices[0]``, concatenated in shard order (the
        staged order). A mesh of distinct devices has one shard per run; a
        mesh that repeats a device, one run per device. No synchronization
        for a numpy pack (a tensor is read back to cut it). Returns (signed
        winners (m,) i32, None): the shards send no distances
        (``_collect_d2`` recomputes them in float64)."""
        if isinstance(packed, torch.Tensor):
            packed = packed.cpu().numpy()
        packed = np.asarray(packed, dtype=np.float32)
        cuts, gl, parts = self._shard_cuts(packed), self.g_local, []
        for dev, lo, hi in self._runs:
            if cuts[lo] == cuts[hi + 1]:
                continue  # no rows: nothing launched
            rows = _upload(packed[cuts[lo]:cuts[hi + 1]], dev)
            sid, pos = rows[:, 3:5].long().unbind(1)
            if lo:
                sid = sid - lo * gl
            dense = torch.zeros(((hi - lo + 1) * gl, q_max, 3), dtype=torch.float32, device=dev)
            dense[sid, pos] = rows[:, :3]
            tables = []
            for j in range(lo, hi + 1):
                if cuts[j] == cuts[j + 1]:  # no launch; no row reads these slots
                    tables.append(torch.empty((gl, q_max), dtype=torch.int32, device=dev))
                    continue
                _, halo_dm, halo_ids = self.shards[j]
                part = dense[(j - lo) * gl:(j - lo + 1) * gl]
                tables.append(cell_scan(part, halo_dm, halo_ids, self.halo2)[1])
            table = tables[0] if len(tables) == 1 else torch.cat(tables)
            parts.append(table[sid, pos].to(self.device))
        if not parts:
            return torch.empty(0, dtype=torch.int32, device=self.device), None
        return torch.cat(parts), None

    def query_queue(self, batches, return_coverage: bool = False):
        """EXACT answers for several query batches, staged on the host: per
        batch the host sort (``stage``), whose pack the shards cut
        (``_shard_cuts``), then ``query_staged`` per pack (one upload per run
        of shards); the signed winners of the whole queue are concatenated
        on ``devices[0]`` and downloaded once; then the host answers each
        batch as the base drain does (``_answer_queue``), putting its
        winners back in query order first. A NaN or an infinity in any
        row raises ValueError on the host first: this drain never runs
        ``bin_queue``, whose count the base drain checks."""
        if not batches:
            return ([], []) if return_coverage else []
        queries = [np.ascontiguousarray(qb, dtype=np.float32) for qb in batches]
        if not all(np.isfinite(q).all() for q in queries):
            raise non_finite_error("queries")
        staged = [self.stage(q) for q in queries]
        with span("nns.cells.device"):
            rows = [self.query_staged(packed, q_max)[0] for packed, _, q_max in staged
                    if packed is not None]
        flat = None
        if rows:
            with span("nns.cells.download"):
                flat = torch.cat(rows).cpu().numpy()
            count_copy("down", flat.nbytes, self.device)
        signed, off = [], 0
        for packed, order, _ in staged:
            m = 0 if packed is None else len(order)
            signed.append(None if packed is None else flat[off:off + m])
            off += m
        return self._answer_queue(queries, signed, [order for _, order, _ in staged],
                                  return_coverage)

    def query_queue_staged(self, denses):
        """Device half of the host-staged queue (no serving path uses it):
        per batch, each shard scans its group range of the (G, qm_b, 3)
        dense rows (zero rows for the padding groups), and the shards'
        winner tables are concatenated on ``devices[0]``. Returns the tuple
        of (g_pad, qm_b) i32 tables, rows past G belonging to the padding
        groups; no synchronization."""
        if not isinstance(denses, (tuple, list)):
            raise TypeError("query_queue_staged takes a sequence of per-batch dense arrays")
        gl, tables = self.g_local, []
        for dense in denses:
            parts = []
            for j, (dev, halo_dm, halo_ids) in enumerate(self.shards):
                d = as_f32(dense[j * gl:(j + 1) * gl], dev)
                if d.shape[0] < gl:
                    d = torch.nn.functional.pad(d, (0, 0, 0, 0, 0, gl - d.shape[0]))
                parts.append(cell_scan(d, halo_dm, halo_ids, self.halo2)[1].to(self.device))
            tables.append(torch.cat(parts))
        return tuple(tables)

    def _collect_d2(self, rows: np.ndarray, order: np.ndarray, idx: np.ndarray,
                    token: CellToken) -> np.ndarray:
        """best_d2 recomputed in float64 from each row's decoded candidate:
        the true NN distance of the f32 inputs on certified rows, and a sound
        upper bound on it on the others (any candidate's distance bounds the
        minimum; an f32 recompute could round ~1 ulp below the truth). On a
        row with an empty halo set it is the finite distance to candidate 0,
        where the single-device engine gives the sentinel's distance."""
        diff = token.queries.astype(np.float64) - self.refs[idx].astype(np.float64)
        return np.einsum("ij,ij->i", diff, diff)

    def _topk_staged(self, packed: np.ndarray, k_nn: int):
        """Each shard answers the staged rows of its groups (rows are sorted
        by group, so each shard's are one slice); the results go back to
        ``devices[0]`` by row."""
        cuts = self._shard_cuts(packed)
        parts = []
        for j, (dev, halo_dm, halo_ids) in enumerate(self.shards):
            staged = torch.as_tensor(packed[cuts[j]:cuts[j + 1]], device=dev)
            out = _device_query_topk(staged[:, :3], staged[:, 3].long() - j * self.g_local,
                                     halo_dm, halo_ids, self.halo2, k_nn)
            parts.append([t.to(self.device) for t in out])
        return tuple(torch.cat(p).cpu().numpy() for p in zip(*parts))

    def _host_halo_dm(self) -> np.ndarray:
        """The logical (G, 3, R_max) halo points, fetched from the shards."""
        return torch.cat([h.cpu() for _, h, _ in self.shards])[:self.D ** 3].numpy()

    @classmethod
    def load(cls, path: str, mesh: Mesh | None = None) -> "ShardedCellEngine":
        """Restore a single-device-format npz (either package's) onto
        ``mesh`` (default: every CUDA device): padding and placement are
        derived for this mesh, so a file written at one mesh size loads at
        any other."""
        if mesh is None:
            mesh = make_mesh()
        eng = cls.__new__(cls)
        eng._set_mesh(mesh)
        eng._restore(path, mesh.devices[0])
        return eng


def nns_sharded_cells(queries, refs, mesh: Mesh | None = None, device="cuda") -> np.ndarray:
    """One-shot sharded flagship over ``mesh`` (default: every device of
    ``device``'s type). One device, refs that are not 3-D or fewer than
    4096 go to the single-device paths; refs too clustered for the index go
    to v8."""
    if mesh is None:
        mesh = make_mesh(device=device)
    if mesh.size == 1 or refs.shape[1] != 3 or refs.shape[0] < 4096:
        return nns_cell_list(np.asarray(queries), np.asarray(refs), device=mesh.devices[0])
    try:
        eng = ShardedCellEngine(np.asarray(refs), mesh)
    except ValueError:
        return nns_sharded(queries, refs, mesh=mesh).cpu().numpy()
    return eng.query(np.asarray(queries))
