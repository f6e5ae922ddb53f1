"""The beam indexes (v14's octree promotion, v9's KD ladder, v11 and v13):
``BeamIndex.query_staged_with_coverage`` hands back the answers of a
staged query set (the concatenated queue of a drain): the rows that
``_decode`` certified, those the wider beam certified and those the exact
fallback re-answered. The fault alters the first row of each batch of
``rows`` there, whichever of the three answered it."""


def plant(setattr, rows: int) -> dict:
    from nns_tpu_torch.trees.beam import BeamIndex

    fired = {"fired": 0}
    answer = BeamIndex.query_staged_with_coverage

    def altered(self, st, beam=8, budget=None):
        idx, cov = answer(self, st, beam, budget)
        if len(idx):
            idx[::rows] += 1
            fired["fired"] += 1
        return idx, cov

    setattr(BeamIndex, "query_staged_with_coverage", altered)
    return fired
