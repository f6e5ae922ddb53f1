"""The v14 supercell engine's host answers: ``CellListEngine._exact_rows``
hands back each batch's final answers on every host path (a single
batch's call, the queue drain on a CPU device, the sharded drain), after
the decode (``_unstage``) and the exact re-answer of its uncertified rows.
The fault alters the first row of each batch there, so that a row the
fallback re-answers is altered as well."""


def plant(setattr, rows: int) -> dict:
    from nns_tpu_torch.kernels.cell_list import CellListEngine

    fired = {"fired": 0}
    exact_rows = CellListEngine._exact_rows

    def altered(self, queries, idx, ok):
        out = exact_rows(self, queries, idx, ok)
        if len(out):
            out[0] += 1
            fired["fired"] += 1
        return out

    setattr(CellListEngine, "_exact_rows", altered)
    return fired
