"""The port's sharded brute force (v8, ``parallel/sharded.py``), its 2-D
form and the ring (``parallel/ring.py``) against the JAX package's, on CPU
torch: every case of tests/test_sharded.py but the mesh's device count and
the 2^24-ref ring. The port runs on ``Mesh.virtual(D, "cpu")`` (one CPU
repeated D times: D shards, D local plain-v4 runs and the real merge), the
JAX package on ``make_mesh(D)`` of the 8 virtual CPU devices that
tests/conftest.py gives it.

Tolerance: index arrays exactly equal to the JAX package's (both merges
keep the lowest global index among equal distances), and recall@1 = 1.0
against the f64 oracle."""

import numpy as np
import pytest
import torch

from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu.kernels.pallas_fused import nns_fused as jax_nns_fused
from nns_tpu.parallel import mesh as jax_mesh
from nns_tpu.parallel import ring as jax_ring
from nns_tpu.parallel import sharded as jax_sharded
from nns_tpu_torch.parallel import mesh
from nns_tpu_torch.parallel.dryrun import dryrun_multichip
from nns_tpu_torch.parallel.mesh import Mesh, best_mesh, make_mesh
from nns_tpu_torch.parallel.ring import nns_ring, ring_argmin
from nns_tpu_torch.parallel.sharded import (ShardedBruteForce, fold_min_idx, nns_sharded,
                                            sharded_argmin, sharded_argmin_2d)


def _virtual(n_dev):
    return Mesh.virtual(n_dev, "cpu")


def _jax_2d(shape):
    from jax.sharding import Mesh as JMesh

    return JMesh(np.array(jax_mesh.make_mesh(shape[0] * shape[1]).devices).reshape(shape),
                 ("dp", "shard"))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_exact_across_mesh_sizes(n_dev):
    q, r = make_dataset(k=3, m=64, n=4096, seed=1000)
    got = nns_sharded(q, r, mesh=_virtual(n_dev)).numpy()
    want = np.asarray(jax_sharded.nns_sharded(q, r, mesh=jax_mesh.make_mesh(n_dev), tile_n=512))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert_exact(got, q, r)


def test_sharded_matches_single_chip():
    q, r = make_dataset(k=16, m=32, n=2048, seed=5)
    got = sharded_argmin(q, r, _virtual(8)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_nns_fused(q, r)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sharded.sharded_argmin(q, r, jax_mesh.make_mesh(8), tile_n=256)))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_unaligned_n(n_dev):
    # n = 999 on 8 shards of 128: the last has 103 real columns, the rest
    # copies of refs[0], which lose every tie: no index >= n comes out.
    q, r = make_dataset(k=3, m=17, n=999, seed=9)
    eng = ShardedBruteForce(r, _virtual(n_dev))
    assert eng.shard_n * n_dev == 1024
    d, got = eng.query_min_idx(q)
    want = np.asarray(jax_sharded.sharded_argmin(q, r, jax_mesh.make_mesh(n_dev), tile_n=128))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < 999
    assert_exact(got.numpy(), q, r)


def test_sharded_tiebreak_lowest_global_index():
    rng = np.random.default_rng(1)
    r = rng.random((1024, 3), dtype=np.float32)
    target = np.array([0.3, 0.6, 0.9], dtype=np.float32)
    for dup in (5, 400, 900):  # shards 0, 3, 7 for 8 shards of 128
        r[dup] = target
    q = np.stack([target, target + np.float32(1e-3)])
    got = sharded_argmin(q, r, _virtual(8)).numpy()
    assert got[0] == 5
    np.testing.assert_array_equal(
        got, np.asarray(jax_sharded.sharded_argmin(q, r, jax_mesh.make_mesh(8), tile_n=128)))


def test_fold_prefers_lower_index_among_equal_distances():
    # The merge's contract, whatever order the shards come in.
    best_d = torch.tensor([1.0, 2.0, 3.0, float("inf")])
    best_i = torch.tensor([7, 7, 7, 9], dtype=torch.int32)
    d = torch.tensor([1.0, 1.5, 3.0, float("inf")])
    i = torch.tensor([3, 9, 8, 2], dtype=torch.int32)
    out_d, out_i = fold_min_idx(best_d, best_i, d, i)
    assert out_d.tolist() == [1.0, 1.5, 3.0, float("inf")]
    assert out_i.tolist() == [3, 9, 7, 2]


def test_best_mesh_degenerate_tiny_n():
    # Fewer reference points than devices: at most one device per point.
    assert best_mesh(3, device="cpu").size == 1
    assert make_mesh(device="cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="requested 2 cpu devices, have 1"):
        make_mesh(2, device="cpu")


def test_best_mesh_on_four_devices(monkeypatch):
    monkeypatch.setattr(mesh, "_devices", lambda device: [torch.device("cpu")] * 4)
    assert best_mesh(3, device="cpu").size == 3
    assert best_mesh(4096, device="cpu").size == 4
    # n = 5 on 4 shards: three shards hold replicas of refs[0] only.
    q, r = make_dataset(k=3, m=9, n=5, seed=2)
    got = nns_sharded(q, r, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sharded.nns_sharded(q, r)))
    assert int(got.max()) < 5


def test_make_mesh_cuda_raises_without_a_card():
    if torch.cuda.device_count():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="no cuda device"):
        make_mesh()
    with pytest.raises(ValueError, match="no cuda device"):
        best_mesh(4096, device="cuda")
    with pytest.raises(ValueError, match="no cuda device"):
        nns_sharded(np.zeros((1, 3), np.float32), np.zeros((8, 3), np.float32))


def test_mesh_shapes():
    m2 = Mesh.virtual((2, 3), "cpu")
    assert (m2.shape, m2.size) == ((2, 3), 6)
    assert Mesh.virtual(4, "cuda").devices == (torch.device("cuda", 0),) * 4
    with pytest.raises(ValueError, match="do not fill"):
        Mesh((torch.device("cpu"),) * 3, (2, 2))
    with pytest.raises(ValueError, match="1-D or 2-D"):
        Mesh.virtual((2, 2, 2), "cpu")
    with pytest.raises(ValueError, match="1-D mesh"):
        sharded_argmin(np.zeros((1, 3), np.float32), np.zeros((8, 3), np.float32), m2)
    with pytest.raises(ValueError, match="2-D mesh"):
        sharded_argmin_2d(np.zeros((1, 3), np.float32), np.zeros((8, 3), np.float32),
                          _virtual(4))


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 2)])
def test_sharded_2d_padding_on_both_axes(shape):
    # Queries padded to n_dp * 8 rows and refs to n_shard * 128 columns.
    q, r = make_dataset(3, 33, 777, seed=44)
    got = sharded_argmin_2d(q, r, Mesh.virtual(shape, "cpu")).numpy()
    want = np.asarray(jax_sharded.sharded_argmin_2d(q, r, _jax_2d(shape), tile_m=64,
                                                    tile_n=128))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sharded_argmin(q, r, _virtual(shape[1])).numpy())
    assert_exact(got, q, r)


# -- the ring (parallel/ring.py) ---------------------------------------------


def test_ring_matches_oracle_and_allgather():
    q, r = make_dataset(3, 64, 8 * 256, seed=41)
    got = ring_argmin(q, r, _virtual(8)).numpy()
    want = np.asarray(jax_ring.ring_argmin(q, r, jax_mesh.make_mesh(8), tile_m=64, tile_n=128))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sharded_argmin(q, r, _virtual(8)).numpy())
    assert_exact(got, q, r)


def test_ring_duplicate_tiebreak_lowest_global_index():
    rng = np.random.default_rng(42)
    base = rng.random((256, 3), dtype=np.float32)
    r = np.tile(base, (8, 1))  # every point duplicated on every shard
    q = base[:32] + np.float32(1e-5)
    got = ring_argmin(q, r, _virtual(8)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_ring.ring_argmin(q, r, jax_mesh.make_mesh(8), tile_m=64,
                                             tile_n=128)))
    d = np.sum((q[:, None].astype(np.float64) - r[None].astype(np.float64)) ** 2, -1)
    dmin = d.min(axis=1)
    for i in range(len(q)):
        ties = np.flatnonzero(d[i] <= dmin[i] * (1 + 1e-12) + 1e-18)
        assert got[i] == ties.min()


def test_ring_on_a_2d_mesh_uses_its_first_axis():
    q, r = make_dataset(3, 40, 1500, seed=45)
    got = ring_argmin(q, r, Mesh.virtual((4, 2), "cpu")).numpy()
    np.testing.assert_array_equal(got, ring_argmin(q, r, _virtual(4)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jax_ring.ring_argmin(q, r, _jax_2d((4, 2)), tile_m=64, tile_n=128)))


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_ring_uneven_pad_and_single_device_fallback(n_dev):
    q, r = make_dataset(3, 33, 777, seed=43)  # padding on both axes
    got = nns_ring(q, r, mesh=_virtual(n_dev)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ring.nns_ring(q, r)))
    assert_exact(got, q, r)
    if n_dev == 1:
        np.testing.assert_array_equal(nns_ring(q, r, device="cpu").numpy(), got)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_dryrun_multichip_on_cpu(n_dev):
    dryrun_multichip(n_dev, "cpu")
