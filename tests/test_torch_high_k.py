"""v9's high-k adaptation ladder in the PyTorch port against the JAX
package's, on CPU torch: the one-time KD beam probe, its rungs (the chunk
scan, the per-query beams, the retry-dependent beams), the demotions (the
scan to the per-query beam, the beam to the retained expansion engine) and
the exact fallback of beam-uncertified rows through the retained engine.

The six cases mirror tests/test_api.py's ``test_engine_high_k_*`` on the
same seeded inputs and the same configuration. Both engines get the same
batches; after every call the port's engine is the JAX engine's type, with
the same probe state, beam and chunk-scan budget. Tolerances: every answer
has recall@1 = 1.0 against the f64 oracle, and on these tie-free inputs
equals the JAX engine's index array."""

import numpy as np
import pytest

import nns_tpu
import nns_tpu.config
import nns_tpu_torch
import nns_tpu_torch.config
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu_torch.kernels.mxu_expansion import MXUExpansion
from nns_tpu_torch.trees.beam import BeamIndex
from test_torch_native import native_libraries  # noqa: F401  (the guard)

# The JAX package's host library loaded in this process: its numpy KD build
# gives another frontier (tests/test_torch_native.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

_HK_CFG = dict(hk_probe_after=256, hk_promote_n_min=1 << 12)


def _clustered_hk_workload(seed: int = 21, n: int = 8192):
    """tests/test_api.py's workload: 16-D clustered refs and a sampler of
    in-distribution queries."""
    rng = np.random.default_rng(seed)
    _, r = make_dataset(16, 1, n, seed=seed, clustered=True)

    def indist(m: int) -> np.ndarray:
        base = r[rng.integers(0, len(r), size=m)]
        return (base + rng.normal(0, 0.01, size=base.shape)).astype(np.float32)

    return r, indist, rng


def _engines(r, **cfg):
    cfg = {**_HK_CFG, **cfg}
    eng = nns_tpu_torch.NNEngine(9, nns_tpu_torch.config.EngineConfig(**cfg), device="cpu")
    jeng = nns_tpu.NNEngine(9, nns_tpu.config.EngineConfig(**cfg))
    return eng.build(r), jeng.build(r)


def _rung(eng):
    return (type(eng._built).__name__, eng._hk_probed, eng._hk_beam, eng._hk_budget)


def _step(eng, jeng, q, r):
    """One query on both engines: exact, equal answers, the same rung after."""
    got = eng.query(q)
    want = np.asarray(jeng.query(q))
    assert got.dtype == np.int32
    assert_exact(got, q, r)
    np.testing.assert_array_equal(got, want)
    assert _rung(eng) == _rung(jeng)
    return got


def test_high_k_promotes_to_beam_on_clustered():
    r, indist, _ = _clustered_hk_workload()
    eng, jeng = _engines(r)
    assert isinstance(eng._built, MXUExpansion)
    _step(eng, jeng, indist(128), r)
    assert isinstance(eng._built, MXUExpansion)  # below the probe volume
    _step(eng, jeng, indist(128), r)  # crosses 256: probe and promote
    assert eng._hk_probed and isinstance(eng._built, BeamIndex)
    assert eng._built.exact_fallback == eng._hk_fallback
    assert isinstance(eng._hk_mxu, MXUExpansion)
    _step(eng, jeng, indist(300), r)


def test_high_k_promotes_to_chunk_scan_on_large_clustered():
    r, indist, _ = _clustered_hk_workload(seed=31, n=32768)
    eng, jeng = _engines(r)
    _step(eng, jeng, indist(300), r)
    assert isinstance(eng._built, BeamIndex)
    assert eng._hk_budget is not None and eng._hk_budget >= 1
    _step(eng, jeng, indist(1500), r)


def test_high_k_scan_demotes_to_beam_then_mxu():
    r, indist, rng = _clustered_hk_workload(seed=37, n=32768)
    eng, jeng = _engines(r)
    _step(eng, jeng, indist(300), r)
    assert isinstance(eng._built, BeamIndex) and eng._hk_budget is not None
    mxu = eng._hk_mxu
    saw_beam_rung = False
    for _ in range(8):
        _step(eng, jeng, rng.random((128, 16), dtype=np.float32), r)  # out of distribution
        if isinstance(eng._built, BeamIndex) and eng._hk_budget is None:
            saw_beam_rung = True  # first collapse: the budget dropped, the index kept
        if isinstance(eng._built, MXUExpansion):
            break
    assert saw_beam_rung
    assert eng._built is mxu  # second collapse: the retained engine, no rebuild
    _step(eng, jeng, indist(64), r)


def test_high_k_scan_serves_ragged_queue():
    r, indist, _ = _clustered_hk_workload(seed=41, n=32768)
    eng, jeng = _engines(r)
    _step(eng, jeng, indist(300), r)
    assert isinstance(eng._built, BeamIndex) and eng._hk_budget is not None
    batches = [indist(m) for m in (7, 130, 513, 64)]
    outs = eng.query_many(batches)
    want = jeng.query_many(batches)
    assert _rung(eng) == _rung(jeng)
    for b, o, w in zip(batches, outs, want):
        assert o.shape == (b.shape[0],) and o.dtype == np.int32
        assert_exact(o, b, r)
        np.testing.assert_array_equal(o, np.asarray(w))


def test_high_k_uniform_probe_rejects():
    q, r = make_dataset(16, 600, 8192, seed=22)
    eng, jeng = _engines(r)
    _step(eng, jeng, q, r)
    assert eng._hk_probed
    assert isinstance(eng._built, MXUExpansion)


def test_high_k_demotes_back_to_mxu():
    r, indist, rng = _clustered_hk_workload(seed=23)
    eng, jeng = _engines(r)
    _step(eng, jeng, indist(300), r)
    assert isinstance(eng._built, BeamIndex)
    mxu = eng._hk_mxu
    for _ in range(3):
        _step(eng, jeng, rng.random((128, 16), dtype=np.float32), r)
        if isinstance(eng._built, MXUExpansion):
            break
    assert eng._built is mxu  # the retained engine, no rebuild
    _step(eng, jeng, indist(64), r)


def test_high_k_probes_once_per_build():
    # VERDICT weak #2, kept as the JAX package has it: after a demotion the
    # engine never probes again, however well the beam would now cover;
    # only a new build re-arms the probe.
    r, indist, rng = _clustered_hk_workload(seed=23)
    eng, jeng = _engines(r)
    _step(eng, jeng, indist(300), r)
    assert isinstance(eng._built, BeamIndex)
    for _ in range(3):
        _step(eng, jeng, rng.random((128, 16), dtype=np.float32), r)
    assert isinstance(eng._built, MXUExpansion)
    for _ in range(3):
        _step(eng, jeng, indist(300), r)  # 900 in-distribution queries
    assert isinstance(eng._built, MXUExpansion) and eng._hk_probed
    eng.build(r)
    jeng.build(r)
    assert not eng._hk_probed and eng._hk_mxu is None
    _step(eng, jeng, indist(300), r)
    assert isinstance(eng._built, BeamIndex)


@pytest.mark.parametrize("k,n,probes", [(8, 8192, True), (17, 8192, False), (16, 4095, False)])
def test_high_k_probe_gates(k, n, probes):
    # The probe needs k <= kd_max_k and n >= hk_promote_n_min, and waits
    # for hk_probe_after queries.
    q, r = make_dataset(k, 300, n, seed=k + n)
    eng, jeng = _engines(r)
    _step(eng, jeng, q[:200], r)
    assert not eng._hk_probed
    _step(eng, jeng, q[200:], r)
    assert eng._hk_probed == probes
