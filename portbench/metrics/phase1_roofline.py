"""phase1_roofline (%, layer: kernels): the phase-1 kernels' share of the
roofline of the distance work of each call. A call of m queries over n
refs of k dims needs 2 m n k operations, taken at the bf16 tensor peak (so
that no exact method can read above 100%), or its bytes at the HBM peak,
whichever takes longer. The six products of the port's bf16x3 split and
its padded k count nowhere. The time is the summed device time of the
kernels whose name holds ``phase1_`` (the wgmma, sliced, mma.sync and
merge kernels) in the traced window; the calls are those answered there."""

from portbench import peaks


def read(run):
    t = run.trace
    busy = t.device_s("phase1_") if t is not None else 0.0
    if busy <= 0 or not run.calls:
        return None
    n, k = run.config["n"], run.config["k"]
    m = run.traffic["rows"] * run.traffic["batches_per_call"]
    floor = peaks.floor_s(2.0 * m * n * k, peaks.nn_bytes(m, n, k))
    return 100.0 * run.calls * floor / busy
