"""The multi-device layer on a single-controller device mesh (see
``mesh.py``). Counterpart of ``nns_tpu/parallel``."""

from nns_tpu_torch.parallel.mesh import Mesh, best_mesh, make_mesh  # noqa: F401
from nns_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedBruteForce,
    nns_sharded,
    sharded_argmin,
    sharded_argmin_2d,
)
from nns_tpu_torch.parallel.ring import nns_ring, ring_argmin  # noqa: F401
from nns_tpu_torch.parallel.sharded_cells import (  # noqa: F401
    ShardedCellEngine,
    nns_sharded_cells,
)
