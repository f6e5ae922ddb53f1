"""The v4 fused engine: ``FusedBruteForce.query`` hands back its indices,
whether it serves the queries itself (v4, and v14 after a demotion from
the beam) or re-answers another engine's uncertified rows (``fallback``).
The fault alters the first row of each batch of ``rows`` there."""


def plant(setattr, rows: int) -> dict:
    from nns_tpu_torch.kernels.fused import FusedBruteForce

    fired = {"fired": 0}
    query = FusedBruteForce.query

    def altered(self, queries):
        idx = query(self, queries).clone()
        if idx.numel():
            idx[::rows] += 1
            fired["fired"] += 1
        return idx

    setattr(FusedBruteForce, "query", altered)
    return fired
