"""nns_tpu_torch — the PyTorch + CUDA port of nns_tpu (exact nearest-neighbor
search), for NVIDIA Hopper (H100, sm_90a).

The JAX package ``nns_tpu`` stays the reference; this package imports torch
and numpy and never jax or nns_tpu. Ported so far: the supercell serving
path (v14, ``NNEngine("cells")`` build / query / query_many) and the v4
fused brute force that re-answers the rows the supercell certificate cannot
prove. Their two kernels are hand-written CUDA C++ in ``csrc/``, built with
nvcc at first use. Every kernel wrapper dispatches on the device of its
tensors: CPU tensors run the plain PyTorch version, CUDA tensors launch the
kernel or raise.

Exactness contract: recall@1 = 1.0 — every version returns a true nearest
neighbor of the float32 inputs (verified against a float64 oracle).
"""

__version__ = "0.1.0"

from nns_tpu_torch.api import nns, get_version, list_versions, NNEngine  # noqa: F401
from nns_tpu_torch.config import BenchConfig, REFERENCE_GRID, DEFAULT_SEED  # noqa: F401
