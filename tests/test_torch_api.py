"""Public API of the PyTorch port against the JAX package, on CPU torch:
``nns`` and ``NNEngine`` for v4 and v14, the registry, and input
validation (the rest of the ported ladder is in test_torch_ladder.py, v9
in test_torch_mxu_expansion.py).

Tolerances: v4 indices exactly equal to the JAX package's. v14 answers
must have recall@1 = 1.0 against the f64 oracle with certified rows true
nearest neighbours; on these seeded tie-free inputs they also equal the
JAX package's indices exactly. No distances are compared here."""

import numpy as np
import pytest

import nns_tpu
import nns_tpu_torch
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu_torch.kernels.cell_list import CellListEngine
from nns_tpu_torch.kernels.fused import FusedBruteForce

UNPORTED = [8, 10, 11, 12, 13]


@pytest.mark.parametrize("k,m,n", [(3, 128, 4096), (16, 64, 2048), (5, 33, 777)])
def test_nns_v4_equals_jax(k, m, n):
    q, r = make_dataset(k, m, n, seed=k * m)
    want = np.asarray(nns_tpu.nns(q, r, version=4))
    for version in (4, "fused", "auto"):
        got = nns_tpu_torch.nns(q, r, version=version, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("version", [14, "cells"])
def test_nns_cells_equals_jax(version):
    q, r = make_dataset(3, 200, 16384, seed=2)
    got = nns_tpu_torch.nns(q, r, version=version, device="cpu")
    assert_exact(got, q, r)
    np.testing.assert_array_equal(got, np.asarray(nns_tpu.nns(q, r, version=14)))


def test_engine_cells_build_query_many_equals_jax():
    q, r = make_dataset(3, 600, 32768, seed=5)
    rng = np.random.default_rng(6)
    batches = [q[:300], q[300:], rng.random((50, 3), dtype=np.float32) * 2 - 0.5]
    eng = nns_tpu_torch.NNEngine("cells", device="cpu").build(r)
    jeng = nns_tpu.NNEngine("cells").build(r)
    assert isinstance(eng._built, CellListEngine)
    got = eng.query_many(batches)
    want = jeng.query_many(batches)
    for g, w, qb in zip(got, want, batches):
        assert g.dtype == np.int32
        assert_exact(g, qb, r)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(eng.query(q), np.asarray(jeng.query(q)))
    # certified rows are true nearest neighbours
    idx, ok = eng._built.query_with_flags(batches[2])
    assert not ok.all()
    assert_exact(idx[ok], batches[2][ok], r)


def test_engine_v4_build_query_many_equals_jax():
    q, r = make_dataset(16, 300, 5000, seed=9)
    eng = nns_tpu_torch.NNEngine(4, device="cpu").build(r)
    assert isinstance(eng._built, FusedBruteForce)
    want = np.asarray(nns_tpu.NNEngine(4).build(r).query(q))
    np.testing.assert_array_equal(eng.query(q), want)
    parts = eng.query_many([q[:100], q[100:]])
    np.testing.assert_array_equal(np.concatenate(parts), want)
    assert eng.query_many([]) == []


@pytest.mark.parametrize("k,n,expect", [(3, 65536, 14), (3, 20000, 4), (16, 65536, 9)])
def test_engine_auto_choice(k, n, expect):
    q, r = make_dataset(k, 16, n, seed=3)
    eng = nns_tpu_torch.NNEngine(device="cpu").build(r)
    assert eng.spec.num == expect
    assert_exact(eng.query(q), q, r)


def test_engine_cells_small_or_clustered_degrades_to_fused():
    q, r = make_dataset(3, 32, 2000, seed=4)
    eng = nns_tpu_torch.NNEngine("cells", device="cpu").build(r)
    assert isinstance(eng._built, FusedBruteForce)
    assert_exact(eng.query(q), q, r)


def test_engine_defers_promotion_on_poor_coverage():
    # Queries far outside the data box defeat the certificate. The JAX
    # engine would promote to the beam index (not ported); the port counts
    # a deferred promotion and keeps answering exactly.
    _, r = make_dataset(3, 1, 16384, seed=8)
    rng = np.random.default_rng(8)
    eng = nns_tpu_torch.NNEngine("cells", device="cpu").build(r)
    for _ in range(2):
        q = rng.random((200, 3), dtype=np.float32) * 4 + 2
        assert_exact(eng.query(q), q, r)
    assert eng.promotions_deferred >= 1
    assert isinstance(eng._built, CellListEngine)


@pytest.mark.parametrize("version", UNPORTED)
def test_unported_versions_raise(version):
    q, r = make_dataset(3, 4, 64, seed=1)
    spec = nns_tpu_torch.get_version(version)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, slice"):
        nns_tpu_torch.nns(q, r, version=spec.name, device="cpu")
    with pytest.raises(NotImplementedError, match=spec.name):
        nns_tpu_torch.NNEngine(version, device="cpu").build(r)


def test_registry_names_match_jax():
    port = [(s.num, s.name, s.family) for s in nns_tpu_torch.list_versions()]
    jax = [(s.num, s.name, s.family) for s in nns_tpu.list_versions()]
    assert port == jax
    for num, name, _ in port:
        assert nns_tpu_torch.get_version(name).num == num
        assert nns_tpu_torch.get_version(str(num)).name == name
    with pytest.raises(KeyError):
        nns_tpu_torch.get_version("nope")


def test_input_validation():
    q, r = make_dataset(3, 8, 100, seed=0)
    bad = q.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        nns_tpu_torch.nns(bad, r, device="cpu")
    r_inf = r.copy()
    r_inf[3, 1] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        nns_tpu_torch.nns(q, r_inf, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        nns_tpu_torch.NNEngine(4, device="cpu").build(r_inf)
    eng = nns_tpu_torch.NNEngine(4, device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        eng.query(q)
    eng.build(r)
    with pytest.raises(ValueError, match="non-finite"):
        eng.query(bad)
    with pytest.raises(ValueError, match="non-finite"):
        eng.query_many([q, bad])
    with pytest.raises(ValueError, match="dimension mismatch"):
        eng.query(q[:, :2])
    with pytest.raises(ValueError, match="dimension mismatch"):
        nns_tpu_torch.nns(q[:, :2], r, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        nns_tpu_torch.nns(q, r[:0], device="cpu")
