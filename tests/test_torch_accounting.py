"""The port's per-device work accounting (``parallel/accounting.py``, a copy
of the JAX package's) against the JAX package's: the three ``*_work``
functions over a grid of (m, n, D, k), and ``sharded_cells_work`` on live
engines of both packages over the same refs. Tolerance: every field equal.
"""

import dataclasses

import numpy as np
import pytest

import nns_tpu.parallel.accounting as jax_acc
import nns_tpu_torch.parallel.accounting as acc
from nns_tpu.parallel import sharded_cells as jax_sc
from nns_tpu.parallel.mesh import make_mesh
from nns_tpu_torch.parallel.mesh import Mesh
from nns_tpu_torch.parallel.sharded_cells import ShardedCellEngine
from test_torch_native import native_libraries  # noqa: F401  (the guard)

GRID = [(m, n, d, k) for m in (1, 17, 10_000) for n in (5, 999, 1 << 20)
        for d in (1, 2, 3, 8) for k in (3, 16)]


@pytest.mark.parametrize("name", ["sharded_argmin_work", "ring_argmin_work"])
def test_shape_work_equals_jax(name):
    port, jax = getattr(acc, name), getattr(jax_acc, name)
    for m, n, d, k in GRID:
        got = dataclasses.astuple(port(m, n, d, k))
        assert got == dataclasses.astuple(jax(m, n, d, k)), (m, n, d, k)


def test_per_device_pairs_fall_inverse_in_d():
    base = acc.sharded_argmin_work(10_000, 1 << 20, 1)
    for d in (2, 4, 8):
        w = acc.sharded_argmin_work(10_000, 1 << 20, d)
        assert w.pairs_scanned == pytest.approx(base.pairs_scanned / d, rel=0.02)
        assert w.collective_payload_bytes == base.collective_payload_bytes


@pytest.mark.usefixtures("native_libraries")
@pytest.mark.parametrize("n_dev,d_per_dim", [(2, None), (8, None), (8, 3)])
def test_sharded_cells_work_equals_jax_on_live_engines(n_dev, d_per_dim):
    rng = np.random.default_rng(9)
    r = rng.random((32768, 3), dtype=np.float32)
    kw = {} if d_per_dim is None else dict(d_per_dim=d_per_dim)
    eng = ShardedCellEngine(r, Mesh.virtual(n_dev, "cpu"), **kw)
    jeng = jax_sc.ShardedCellEngine(r, make_mesh(n_dev), **kw)
    assert (eng.g_pad, eng.g_local, eng.R_max) == (jeng.g_pad, jeng.g_local, jeng.R_max)
    for w, q_max in ((4, 16), (64, 8), (1, 2048)):
        assert dataclasses.astuple(acc.sharded_cells_work(eng, w, q_max)) == \
            dataclasses.astuple(jax_acc.sharded_cells_work(jeng, w, q_max))
