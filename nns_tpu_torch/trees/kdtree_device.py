"""Device KD-tree query — the v11 analog. Counterpart of
``nns_tpu/trees/kdtree_device.py``.

The tree is built on the host (kdtree.py); its depth-T subtrees become the
boxed point buckets of a beam frontier index (trees/beam.py) on the device.
Every query ranks all buckets by box distance, scans its ``beam`` nearest
exactly and certifies the winner against the (beam+1)-th bound; the
uncertified rows take a wider beam, then the exact v4 kernel.
"""

from __future__ import annotations

import numpy as np


def kd_query_device(tree, queries, beam: int = 8, device="cuda") -> np.ndarray:
    """Exact batched device query through the tree's beam frontier index.
    A too-small beam only shrinks certificate coverage — uncertified
    queries are re-answered by the exact fused scan, never returned wrong."""
    return tree.device_index(device).query_exact(queries, beam=beam)


def nns_kdtree_device(queries, refs, max_k: int = 16, device="cuda") -> np.ndarray:
    """v11: KD-tree host build + batched device query; k > max_k falls
    back to the linear scan (reference contract, core.cu:1435-1436), and
    6 < k <= max_k to the fused device kernel — high-dimensional KD pruning
    degenerates toward a full scan, which the dense kernel does faster."""
    if refs.shape[1] > max_k:
        from nns_tpu_torch.kernels.oracle import linear_scan

        return linear_scan(queries, refs)
    if refs.shape[1] > 6:
        from nns_tpu_torch.kernels.fused import fused_fallback

        return fused_fallback(queries, refs, device).cpu().numpy()
    from nns_tpu_torch.trees.kdtree import KDTree

    return kd_query_device(KDTree.build(refs), queries, device=device)
