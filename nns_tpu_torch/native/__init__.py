"""Native C++ host layer: the JAX package's ``nns_cpu.cpp``, built by path
into the port's own build directory and loaded with ctypes (see build.py)."""

from nns_tpu_torch.native.build import (  # noqa: F401
    ensure_built,
    load_library,
    native_available,
    native_cells_build,
    native_cells_stage,
    native_linear_scan,
)
