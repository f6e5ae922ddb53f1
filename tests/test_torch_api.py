"""Public API of the PyTorch port against the JAX package, on CPU torch:
``nns`` and ``NNEngine`` for v4, v8 and v14, v14's adaptation ladder (the
promotion to the octree beam index and the demotion to the fused engine),
the multi-device choices of "auto" (on a four-device CPU mesh), the
registry (every version runs), and input validation (the rest of the ported ladder is in
test_torch_ladder.py, v9 in test_torch_mxu_expansion.py, the trees in
test_torch_trees.py).

Tolerances: v4 and v8 indices exactly equal to the JAX package's. v14 answers
must have recall@1 = 1.0 against the f64 oracle with certified rows true
nearest neighbours; on these seeded tie-free inputs they also equal the
JAX package's indices exactly. The ladder must land on the same engine
type as the JAX package's after the same batches. No distances are
compared here."""

import numpy as np
import pytest
import torch

import nns_tpu
import nns_tpu.config
import nns_tpu_torch
import nns_tpu_torch.config
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu_torch.kernels.cell_list import CellListEngine
from nns_tpu_torch.kernels.fused import FusedBruteForce
from nns_tpu_torch.parallel import mesh as mesh_mod
from nns_tpu_torch.parallel.sharded import ShardedBruteForce
from nns_tpu_torch.parallel.sharded_cells import ShardedCellEngine
from nns_tpu_torch.trees.beam import BeamIndex


@pytest.fixture
def four_devices(monkeypatch):
    """A machine with four CPU devices, as ``parallel.mesh`` sees it: every
    mesh the API asks for (``make_mesh``, ``best_mesh``) has four shards."""
    monkeypatch.setattr(mesh_mod, "_devices", lambda device: [torch.device("cpu")] * 4)


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


def test_engine_promotes_on_poor_coverage():
    # Queries far outside the data box defeat the certificate: after the
    # miss budget the engine promotes to the octree beam index, as the JAX
    # engine does, and keeps answering exactly.
    _, r = make_dataset(3, 1, 16384, seed=8)
    rng = np.random.default_rng(8)
    eng = nns_tpu_torch.NNEngine("cells", device="cpu").build(r)
    for _ in range(2):
        q = rng.random((200, 3), dtype=np.float32) * 4 + 2
        assert_exact(eng.query(q), q, r)
    assert not eng._hk_probed  # v9's high-k probe is not v14's ladder
    assert isinstance(eng._built, BeamIndex)
    q = rng.random((200, 3), dtype=np.float32) * 4 + 2
    assert_exact(eng.query(q), q, r)


def _shell(n=65536, seed=20):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rad = (0.35 + 0.1 * rng.random(n))[:, None]
    r = (np.float32(0.5) + rad * v).astype(np.float32)
    q = (np.float32(0.5) + rng.random((64, 3), dtype=np.float32) * np.float32(1e-3))
    return r, [q.astype(np.float32)] * 5


def _blobs(seed, uniform_m):
    rng = np.random.default_rng(seed)
    centers = rng.random((64, 3)).astype(np.float32)
    r = (centers[rng.integers(0, 64, 65536)]
         + rng.normal(0, 0.003, (65536, 3))).astype(np.float32)
    return r, [rng.random((uniform_m, 3), dtype=np.float32) for _ in range(3)]


def _uniform(seed, far, good, rounds):
    rng = np.random.default_rng(seed)
    r = rng.random((65536, 3), dtype=np.float32)
    return r, [far, good(rng)] * rounds


def _shape(kwargs):
    q, r = make_dataset(3, 96, 65536, seed=60, **kwargs)
    rng = np.random.default_rng(61)
    lo, hi = kwargs.get("query_box", (0.0, 1.0))
    return r, [q] + [(rng.random((96, 3), dtype=np.float32) * (hi - lo) + lo).astype(np.float32)
                     for _ in range(4)]


# The scenarios of tests/test_api.py:371-541, each a reference set and a
# stream of batches; ``final`` is the engine type both packages must end on.
LADDER = {
    # Refs in a thick shell, queries at its centre: neither index covers,
    # so the engine promotes, then demotes to the fused engine.
    "shell_demotes": (lambda: _shell(), "FusedBruteForce"),
    # Single-query misses between well-covered batches never promote.
    "singletons_stay": (lambda: _uniform(
        24, np.array([[5.0, -2.0, 7.0]], np.float32),
        lambda rng: rng.random((256, 3), dtype=np.float32), 8), "CellListEngine"),
    # Uniform queries over tight blobs promote within two batches.
    "clustered_promotes": (lambda: _blobs(25, 256), "BeamIndex"),
    # A sustained ~40% miss rate promotes although every other batch covers.
    "alternating_promotes": (lambda: _uniform(
        52, np.random.default_rng(52).random((64, 3), dtype=np.float32) + np.float32(5.0),
        lambda rng: rng.random((64, 3), dtype=np.float32), 6), "BeamIndex"),
    "anisotropic": (lambda: _shape(dict(clustered=True, sigma=0.002, anisotropy=50.0)), None),
    "powerlaw": (lambda: _shape(dict(clustered=True, sigma=0.005, n_clusters=512,
                                     powerlaw=True)), None),
    "out_of_box": (lambda: _shape(dict(clustered=True, sigma=0.01, query_box=(-0.5, 1.5))),
                   None),
}


@pytest.mark.parametrize("via", ["query", "query_many"])
@pytest.mark.parametrize("case", sorted(LADDER))
def test_v14_ladder_follows_jax(case, via):
    # After every batch (query) or queue of two batches (query_many), the
    # port's engine is the JAX engine's type, and every answer is exact.
    make, final = LADDER[case]
    r, batches = make()
    cfg = dict(octree_max_depth=6) if final is None else {}
    eng = nns_tpu_torch.NNEngine(14, config=nns_tpu_torch.config.EngineConfig(**cfg),
                                 device="cpu").build(r)
    jeng = nns_tpu.NNEngine(14, config=nns_tpu.config.EngineConfig(**cfg)).build(r)
    assert type(eng._built).__name__ == type(jeng._built).__name__ == "CellListEngine"
    steps = ([[b] for b in batches] if via == "query"
             else [batches[i:i + 2] for i in range(0, len(batches), 2)])
    for step in steps:
        if via == "query":
            got, want = [eng.query(step[0])], [jeng.query(step[0])]
        else:
            got, want = eng.query_many(step), jeng.query_many(step)
        for g, w, qb in zip(got, want, step):
            assert_exact(g, qb, r)
        assert type(eng._built).__name__ == type(jeng._built).__name__
    if final is not None and via == "query":
        assert type(eng._built).__name__ == final
    assert not eng._hk_probed and not jeng._hk_probed


def test_promote_to_beam_honors_octree_max_depth(monkeypatch):
    from nns_tpu_torch.trees import octree as octree_mod

    seen = {}
    real_build = octree_mod.Octree.build.__func__

    def spy(cls, refs, max_depth=9):
        seen["max_depth"] = max_depth
        return real_build(cls, refs, max_depth)

    monkeypatch.setattr(octree_mod.Octree, "build", classmethod(spy))
    _, r = make_dataset(3, 8, 8192, seed=62)
    eng = nns_tpu_torch.NNEngine(
        14, config=nns_tpu_torch.config.EngineConfig(octree_max_depth=6), device="cpu").build(r)
    eng._promote_to_beam()
    assert seen["max_depth"] == 6
    assert isinstance(eng._built, BeamIndex)


def test_engine_query_many_beam_and_fused_concatenate(monkeypatch):
    # A promoted beam index and a demoted fused engine each answer the whole
    # queue in one call, equal to per-batch answers.
    from nns_tpu_torch.trees.octree import Octree

    rng = np.random.default_rng(41)
    r = rng.random((32768, 3), dtype=np.float32)
    batches = [rng.random((m, 3), dtype=np.float32) for m in (100, 37, 260)]
    eng = nns_tpu_torch.NNEngine(14, device="cpu").build(r)
    for built in (Octree.build(r).device_index("cpu"), FusedBruteForce(r, device="cpu")):
        eng._built = built
        calls = []
        real = eng.query
        monkeypatch.setattr(eng, "query", lambda q: calls.append(len(q)) or real(q))
        many = eng.query_many(batches)
        assert calls == [397]
        assert eng._built is built
        for qb, idx in zip(batches, many):
            assert idx.dtype == np.int32
            assert_exact(idx, qb, r)
        monkeypatch.undo()


@pytest.mark.parametrize("version", [s.num for s in nns_tpu_torch.list_versions()])
def test_every_version_runs(version):
    # Every version of the registry answers through nns and NNEngine.
    q, r = make_dataset(3, 16, 2048, seed=12)
    idx = nns_tpu_torch.nns(q, r, version=version, device="cpu")
    assert idx.dtype == np.int32
    assert_exact(idx, q, r)
    eng = nns_tpu_torch.NNEngine(version, device="cpu").build(r)
    np.testing.assert_array_equal(eng.query(q), idx)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("k,m,n", [(3, 64, 4096), (16, 33, 999)])
def test_v8_equals_jax(shards, k, m, n, request):
    # v8 on one CPU device runs v4; on four, the refs are sharded. The JAX
    # package's v8 shards over its 8 virtual CPU devices.
    if shards == 4:
        request.getfixturevalue("four_devices")
    q, r = make_dataset(k, m, n, seed=k + n)
    want = np.asarray(nns_tpu.nns(q, r, version=8))
    for version in (8, "sharded"):
        np.testing.assert_array_equal(nns_tpu_torch.nns(q, r, version=version, device="cpu"),
                                      want)
    eng = nns_tpu_torch.NNEngine(8, device="cpu").build(r)
    assert isinstance(eng._built, ShardedBruteForce if shards == 4 else FusedBruteForce)
    np.testing.assert_array_equal(eng.query(q), want)
    parts = eng.query_many([q[:10], q[10:]])
    np.testing.assert_array_equal(np.concatenate(parts), want)
    np.testing.assert_array_equal(nns_tpu_torch.nns(q, r, device="cpu"),
                                  np.asarray(nns_tpu.nns(q, r)))


def test_auto_multi_device_builds_sharded_flagship(four_devices):
    # tests/test_api.py's case: "auto" on several devices builds the sharded
    # supercell index for a large 3-D set, v8 for other shapes; explicit v14
    # stays the single-device rung. Answers equal the JAX package's.
    rng = np.random.default_rng(70)
    r = rng.random((65536, 3), dtype=np.float32)
    eng = nns_tpu_torch.NNEngine("auto", device="cpu").build(r)
    jeng = nns_tpu.NNEngine("auto").build(r)
    assert type(eng._built) is ShardedCellEngine and eng.spec.num == 14
    assert type(jeng._built).__name__ == "ShardedCellEngine"
    assert eng._built.n_dev == 4
    q = rng.random((200, 3), dtype=np.float32)
    np.testing.assert_array_equal(eng.query(q), np.asarray(jeng.query(q)))
    batches = [rng.random((128, 3), dtype=np.float32) for _ in range(3)]
    for qb, idx in zip(batches, eng.query_many(batches)):
        assert_exact(idx, qb, r)
    assert type(nns_tpu_torch.NNEngine(14, device="cpu").build(r)._built) is CellListEngine
    q16, r16 = make_dataset(16, 32, 4096, seed=71)
    eng16 = nns_tpu_torch.NNEngine("auto", device="cpu").build(r16)
    assert eng16.spec.num == 8 and isinstance(eng16._built, ShardedBruteForce)
    np.testing.assert_array_equal(eng16.query(q16),
                                  np.asarray(nns_tpu.NNEngine("auto").build(r16).query(q16)))


@pytest.mark.parametrize("via", ["query", "query_many"])
def test_sharded_index_never_promotes(four_devices, via):
    # A clustered stream that promotes the single-device index to the beam
    # (LADDER "clustered_promotes") leaves the sharded index in place, as in
    # the JAX package, whose promotion checks the exact type.
    r, batches = _blobs(25, 256)
    eng = nns_tpu_torch.NNEngine("auto", device="cpu").build(r)
    assert type(eng._built) is ShardedCellEngine
    for qb in batches:
        got = eng.query(qb) if via == "query" else eng.query_many([qb, qb[:64]])[0]
        assert_exact(got, qb, r)
        assert type(eng._built) is ShardedCellEngine
    single = nns_tpu_torch.NNEngine("cells", device="cpu").build(r)
    for qb in batches:
        single.query(qb)
    assert isinstance(single._built, BeamIndex)


def _v14_engine(engine, request):
    """NNEngine's single-device supercell index ("cells") over 32768 uniform
    refs, or the sharded one that "auto" builds on four devices over 65536."""
    if engine == "cells":
        _, r = make_dataset(3, 1, 32768, seed=72)
        eng = nns_tpu_torch.NNEngine(14, device="cpu").build(r)
        assert type(eng._built) is CellListEngine
    else:
        request.getfixturevalue("four_devices")
        _, r = make_dataset(3, 1, 65536, seed=72)
        eng = nns_tpu_torch.NNEngine("auto", device="cpu").build(r)
        assert type(eng._built) is ShardedCellEngine
    return eng, r


@pytest.mark.parametrize("engine", ["cells", "sharded_cells"])
def test_v14_query_many_raises_on_non_finite(engine, request, monkeypatch):
    # A NaN or an infinity anywhere in a v14 queue raises ValueError. The
    # single-device drain makes no host pass over the queue (bin_queue
    # counts the bad rows in the pass that bins them); the sharded drain,
    # which stages on the host, keeps the API's check and one of its own.
    import nns_tpu_torch.api as api

    eng, _ = _v14_engine(engine, request)
    rng = np.random.default_rng(73)
    q = rng.random((64, 3), dtype=np.float32)
    checked = []
    check = api._check_finite
    monkeypatch.setattr(api, "_check_finite", lambda a, name: checked.append(name) or check(a, name))
    for value, bad_batch in ((np.nan, -1), (np.inf, 0), (-np.inf, -1)):
        queue = [q.copy(), q.copy(), q[:7].copy()]
        queue[bad_batch][-1, 2] = value
        with pytest.raises(ValueError, match="non-finite"):
            eng.query_many(queue)
        with pytest.raises(ValueError, match="non-finite"):
            eng._built.query_queue(queue)
    # The API's host check stops at the first bad batch: 3 + 1 + 3 batches.
    assert len(checked) == (0 if engine == "cells" else 7)
    with pytest.raises(ValueError, match="non-finite"):
        eng.query(queue[-1])


@pytest.mark.parametrize("engine", ["cells", "sharded_cells"])
def test_v14_query_many_hands_back_the_drains_answers(engine, request, monkeypatch):
    # The single-device drain's int32 answers come back as query_queue made
    # them, not copied; the sharded drain's go through the API's copy. Both
    # are exact and int32.
    eng, r = _v14_engine(engine, request)
    rng = np.random.default_rng(74)
    queue = [rng.random((m, 3), dtype=np.float32) for m in (300, 1, 200)]
    made = []
    drain = eng._built.query_queue
    monkeypatch.setattr(eng._built, "query_queue",
                        lambda batches, **kw: made.append(drain(batches, **kw)) or made[-1])
    got = eng.query_many(queue)
    (answers, _), = made
    assert [a is b for a, b in zip(got, answers, strict=True)] == [engine == "cells"] * 3
    for idx, qb in zip(got, queue):
        assert idx.dtype == np.int32
        assert_exact(idx, qb, r)


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
