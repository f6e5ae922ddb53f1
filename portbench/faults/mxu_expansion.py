"""The v9 expansion engine: ``MXUExpansion._drain_staged`` hands back the
indices of a staged query set (the concatenated queue of a drain) after
phase 1, phase 2, the band refine and the full scan. The fault alters the
first row of each batch of ``rows`` there."""


def plant(setattr, rows: int) -> dict:
    from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion

    fired = {"fired": 0}
    drain = MXUExpansion._drain_staged

    def altered(self, st):
        idx = drain(self, st)
        if idx.numel():
            idx[::rows] += 1
            fired["fired"] += 1
        return idx

    setattr(MXUExpansion, "_drain_staged", altered)
    return fired
