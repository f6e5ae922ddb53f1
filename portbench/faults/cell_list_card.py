"""The v14 queue drain on a CUDA device: ``CellListEngine._answer_on_device``
hands back every batch's answers, decoded by ``cell_answer`` on the card
and completed by one exact fallback a queue. The fault alters the first
row of each batch there. Only a run on the card reaches it: the drain on a
CPU device answers through the host path (``cell_list_host``)."""


def plant(setattr, rows: int) -> dict:
    from nns_tpu_torch.kernels.cell_list import CellListEngine

    fired = {"fired": 0}
    answer = CellListEngine._answer_on_device

    def altered(self, queries, binned):
        results, covs = answer(self, queries, binned)
        for r in results:
            if len(r):
                r[0] += 1
        fired["fired"] += 1
        return results, covs

    setattr(CellListEngine, "_answer_on_device", altered)
    return fired
