"""Device octree query — the v13 analog. Counterpart of
``nns_tpu/trees/octree_device.py``.

The octree is built on the host (octree.py); its maximal <= cap-point
subtrees become the boxed buckets of a beam frontier index (trees/beam.py)
on the device, whose tight point boxes prune harder than the octree cubes.
Each query scans its ``beam`` nearest buckets exactly and certifies against
the (beam+1)-th bound.
"""

from __future__ import annotations

import numpy as np


def octree_query_device(tree, queries, beam: int = 8, device="cuda") -> np.ndarray:
    """Exact batched device query through the tree's beam frontier index.
    A too-small beam only shrinks certificate coverage — uncertified
    queries are re-answered by the exact fused scan, never returned wrong."""
    return tree.device_index(device).query_exact(queries, beam=beam)


def nns_octree_device(queries, refs, max_depth: int = 9, device="cuda") -> np.ndarray:
    """v13: octree host build + batched device query. k != 3 falls back to
    an exact full scan as in the reference (core.cu:1882-1885), on the fused
    device kernel as v11 does."""
    if refs.shape[1] != 3:
        from nns_tpu_torch.kernels.fused import fused_fallback

        return fused_fallback(queries, refs, device).cpu().numpy()
    from nns_tpu_torch.trees.octree import Octree

    return octree_query_device(Octree.build(refs, max_depth=max_depth), queries, device=device)
