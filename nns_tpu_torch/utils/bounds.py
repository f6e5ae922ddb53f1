"""The least time one H100 could take for a kernel's work: the larger of the
bytes it must move (each input read once, each output written once) over
the device memory rate and the operations it does over the published peak
of their type. ``chip_smoke.py`` and ``utils/kernel_report.py`` state their
kernels' bounds with these.

The f32 peak counts an FMA as two operations. The port's brute-force
kernels round every sub, mul and add on its own (no FMA, so that kernel and
plain version are bit-equal), so they can reach at most about
(3k + 1) / (2 x instructions per pair) of ``fused_bound``: 35-45% for
k = 3 to 16.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (data sheet, dense): device memory bytes/s,
# fp32 outside the tensor cores and bf16 on them, operations/s.
PEAK = {"bytes": 3.35e12, "f32": 67e12, "bf16_tensor": 989e12}


def bound(nbytes, **ops) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and to do ``ops[rate]`` operations at each peak rate."""
    t_bytes = nbytes / PEAK["bytes"]
    t_ops = max((count / PEAK[rate] for rate, count in ops.items()), default=0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cell_bin_bound(rows, batches, groups) -> tuple[float, str]:
    """cell_bin over a queue: each (rows, 3) f32 query read once, its sid
    and slot (i32 each) written once, the (batches, D^3) i32 counts written
    once."""
    return bound(20 * rows + 4 * batches * groups)


def cell_place_bound(rows, slots) -> tuple[float, str]:
    """place_queue over a queue: each f32 query and its sid and slot read
    once, its i64 table slot written once, and every slot of the (slots,
    3) f32 table written once (a row there or the zero fill)."""
    return bound(28 * rows + 12 * slots)


def cell_answer_bound(rows) -> tuple[float, str]:
    """cell_answer over a queue after its scans: each row's i64 slot, its
    i32 signed winner and its (3,) f32 query read once, its i32 answer
    written once (the uncertified rows' list is a few rows)."""
    return bound(28 * rows)


def fused_bound(m, n, k) -> tuple[float, str]:
    """A fused argmin over (m, k) queries and (n, k) refs: per pair k
    subtractions, k multiplies, k adds and a compare in f32."""
    return bound(4 * (m * k + n * k) + 8 * m, f32=m * n * (3 * k + 1))


def cell_bound(groups, qm, r_max, real_queries, avg_candidates) -> tuple[float, str]:
    """One cell_scan launch: the dense (G, QM, 3) queries and the whole
    padded (G, 3, R_max) halo and (G, R_max) ids read once (the scan must
    read every halo slot: a sentinel can win a group with no real point),
    (d2, id) per slot written once; each real query against its group's
    real candidates (3 sub, 3 mul, 3 add, 1 compare)."""
    return bound(4 * (groups * qm * 3 + groups * 4 * r_max) + 8 * groups * qm,
                 f32=real_queries * avg_candidates * 10)


def phase1_bound(m, n_pad, kp) -> tuple[float, str]:
    """expansion_phase1: 2 m n 6kp bf16 tensor-core operations, reading qc,
    rc and r2h once and writing six (m,) outputs."""
    return bound(m * 6 * kp * 2 + 3 * kp * n_pad * 2 + 4 * n_pad + 24 * m,
                 bf16_tensor=2 * m * n_pad * 6 * kp, f32=2 * m * n_pad)
