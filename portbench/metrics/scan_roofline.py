"""scan_roofline (%, layer: kernels): the supercell scan's share of its
roofline. The floor of one batch of m queries over n refs of k dims is the
problem's bytes at the HBM peak: every ref read once (a batch spread over
the whole box needs every ref), the queries read once, an (index,
distance) answer written per query. No padding of the port's tables goes
into it. The time is the summed device time of the kernels whose name
holds ``cell_scan`` in the traced window; the batches are those answered
there."""

from portbench import peaks


def read(run):
    t = run.trace
    busy = t.device_s("cell_scan") if t is not None else 0.0
    if busy <= 0 or not run.units:
        return None
    n, k, m = run.config["n"], run.config["k"], run.traffic["rows"]
    return 100.0 * run.units * peaks.floor_s(0, peaks.nn_bytes(m, n, k)) / busy
