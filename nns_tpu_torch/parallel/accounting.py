"""Per-device work accounting for the sharded paths. A copy of
``nns_tpu/parallel/accounting.py`` (its outputs pinned equal by
tests/test_torch_accounting.py); only the ``layouts`` import is the port's.

The reference's multi-GPU scaling story is its shard arithmetic
(core.cu:781-791: thread_n = divup(n, num_gpus), each GPU scans m x
thread_n). These functions derive, from shapes alone, how much scan work,
reference-data traffic and merge payload each device owns. They are shape
arithmetic, not measurements: exact, deterministic and valid for any device
count. The ``collectives`` and payload figures are the JAX package's
(``all_gather`` and ``ppermute`` on a mesh), kept for parity with it. They
do not count the port's own cross-device copies: its gather makes D - 1
``.to`` copies per merged tensor and its ring D - 1 hops.
"""

from __future__ import annotations

from dataclasses import dataclass

from nns_tpu_torch.kernels import layouts

_LANE = 128


@dataclass(frozen=True)
class ChipWork:
    """Shape-derived per-chip accounting for one sharded query batch/drain.

    pairs_scanned: query-reference candidate pairs each chip evaluates
        (the kernels' padded forms — what actually runs, not the ideal).
    ref_bytes_resident: bytes of reference/halo data each chip holds.
    collective_payload_bytes: bytes each chip CONTRIBUTES to collectives
        for the whole batch/drain (the ICI bill; receive side is this
        times (D-1) for an all-gather).
    collectives: number of collective ops issued for the batch/drain.
    """

    n_dev: int
    pairs_scanned: int
    ref_bytes_resident: int
    collective_payload_bytes: int
    collectives: int


def sharded_argmin_work(m: int, n: int, n_dev: int, k: int = 3) -> ChipWork:
    """parallel/sharded.py: refs sharded on n, queries replicated, winners
    all-gathered. Mirrors sharded_argmin's padding (refs to D * LANE)."""
    n_pad = layouts.round_up(n, n_dev * _LANE)
    shard_n = n_pad // n_dev
    m_pad = layouts.round_up(m, 8)
    return ChipWork(
        n_dev=n_dev,
        pairs_scanned=m_pad * shard_n,
        ref_bytes_resident=shard_n * k * 4,
        # two all_gathers (min_d f32 + gidx i32), each m floats per chip
        collective_payload_bytes=2 * m_pad * 4,
        collectives=2,
    )


def ring_argmin_work(m: int, n: int, n_dev: int, k: int = 3) -> ChipWork:
    """parallel/ring.py: queries AND refs sharded, reference blocks rotate
    via ppermute. Per chip: (m/D) x n pairs over D steps; communication is
    D hops of one reference block each."""
    n_pad = layouts.round_up(n, n_dev * _LANE)
    m_pad = layouts.round_up(m, n_dev * 8)
    shard_n = n_pad // n_dev
    m_local = m_pad // n_dev
    return ChipWork(
        n_dev=n_dev,
        pairs_scanned=m_local * shard_n * n_dev,  # = m_local * n_pad
        ref_bytes_resident=shard_n * k * 4,
        # D ppermute hops, each sending this chip's current (shard_n, k)
        # block one neighbor over — O(n/D) per hop, O(n) per query batch,
        # but NEVER materialized in full anywhere.
        collective_payload_bytes=n_dev * shard_n * k * 4,
        collectives=n_dev,
    )


def sharded_cells_work(engine, w: int, q_max: int) -> ChipWork:
    """parallel/sharded_cells.py: supercell groups partitioned over the
    mesh; each chip scans only its groups' dense slots against its halo
    tensors; one all-gather of the (w, g_local, q_max) winner tables per
    sub-drain. ``engine`` is a ShardedCellEngine (uses its real g_local /
    R_max padding)."""
    g_local = engine.g_local
    r_max = engine.R_max
    return ChipWork(
        n_dev=engine.n_dev,
        pairs_scanned=w * g_local * q_max * r_max,
        ref_bytes_resident=g_local * (3 * r_max * 4 + r_max * 4),
        collective_payload_bytes=w * g_local * q_max * 4,
        collectives=1,
    )
