"""nns_tpu_torch — the PyTorch + CUDA port of nns_tpu (exact nearest-neighbor
search), for NVIDIA Hopper (H100, sm_90a).

The JAX package ``nns_tpu`` stays the reference; this package imports torch
and numpy and never jax or nns_tpu. Ported: every version — the supercell
serving path (v14, ``NNEngine("cells")`` with its promotion to the beam
index), the v4 fused brute force that re-answers every uncertified row, the
rest of the brute-force ladder (v0-v3, v5-v7), the v9 split-bf16 expansion
engine, the tree family (v10-v13, ``trees/``) and the multi-device layer
(v8 and the sharded supercell index on a device mesh, ``parallel/``) —
plus exact k-NN (``query_topk``) and index persistence (``save``/``load``). The seven kernels are
hand-written CUDA C++ in ``csrc/``, built with nvcc at first use. Every
kernel wrapper dispatches on the device of its tensors: CPU tensors run
the plain PyTorch version, CUDA tensors launch the kernel or raise.

Exactness contract: recall@1 = 1.0 — every version returns a true nearest
neighbor of the float32 inputs (verified against a float64 oracle).
"""

__version__ = "0.1.0"

from nns_tpu_torch.api import nns, get_version, list_versions, NNEngine  # noqa: F401
from nns_tpu_torch.config import BenchConfig, REFERENCE_GRID, DEFAULT_SEED  # noqa: F401
