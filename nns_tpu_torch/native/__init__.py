"""Native C++ host layer: the package's own copy of ``nns_cpu.cpp``, built
into the port's build directory and loaded with ctypes (see build.py)."""

from nns_tpu_torch.native.build import (  # noqa: F401
    ensure_built,
    load_library,
    native_available,
    native_cells_build,
    native_cells_stage,
    native_kd_build,
    native_kd_query,
    native_linear_scan,
    native_octree_build,
    native_octree_query,
)
