"""Index persistence of the PyTorch port against the JAX package: the
supercell engine's npz (keys ``refs``, ``halo_pts``, ``halo_ids``,
``meta``, ``geo``) and ``NNEngine.save``/``load`` for v10-v14, including
v14's promoted beam form. A file that one package writes loads in the
other, and the loaded engine answers as the one that saved it.

Tolerances: the stored arrays are equal; v10, v12 and v14's supercell
form answer with the JAX package's index arrays; v11, v13 and the beam
form answer at recall@1 = 1.0."""

import numpy as np
import pytest

import nns_tpu
import nns_tpu_torch
from conftest import assert_exact
from nns_tpu.data import make_dataset
from nns_tpu.kernels.cell_list import CellListEngine as JCellListEngine
from nns_tpu.trees.beam import BeamIndex as JBeamIndex
from nns_tpu_torch.kernels.cell_list import CellListEngine
from nns_tpu_torch.trees.beam import BeamIndex
from test_torch_native import native_libraries  # noqa: F401  (the guard)

# The JAX package's host library loaded in this process: its numpy fallbacks
# build other trees (tests/test_torch_native.py).
pytestmark = pytest.mark.usefixtures("native_libraries")


def test_cell_engine_files_equal_and_load_across(tmp_path):
    q, r = make_dataset(3, 300, 16384, seed=31, query_box=(-0.2, 1.2))
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    eng, jeng = CellListEngine(r, device="cpu"), JCellListEngine(r)
    eng.save(ours)
    jeng.save(theirs)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == ["geo", "halo_ids", "halo_pts", "meta", "refs"]
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    want = np.asarray(jeng.query(q))
    for loaded in (CellListEngine.load(ours, device="cpu"), CellListEngine.load(theirs, device="cpu")):
        assert (loaded.D, loaded.R_max, loaded.halo) == (eng.D, eng.R_max, eng.halo)
        assert loaded.avg_candidates == pytest.approx(jeng.avg_candidates)
        np.testing.assert_array_equal(loaded.query(q), want)
    np.testing.assert_array_equal(np.asarray(JCellListEngine.load(ours).query(q)), want)


@pytest.mark.parametrize("version", [10, 11, 12, 13, 14])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_engine_files_load_across_packages(tmp_path, version, direction):
    q, r = make_dataset(3, 200, 8192, seed=version, clustered=True)
    path = str(tmp_path / "eng.npz")
    if direction == "port_to_jax":
        src = nns_tpu_torch.NNEngine(version, device="cpu").build(r)
        src.save(path)
        loaded = nns_tpu.NNEngine.load(path, version)
    else:
        src = nns_tpu.NNEngine(version).build(r)
        src.save(path)
        loaded = nns_tpu_torch.NNEngine.load(path, version, device="cpu")
    np.testing.assert_array_equal(loaded._refs, r)
    got, want = np.asarray(loaded.query(q)), np.asarray(src.query(q))
    assert_exact(got, q, r)
    if version in (10, 12, 14):
        np.testing.assert_array_equal(got, want)
    # And again in the package that wrote it.
    again = type(src).load(path, version, **({"device": "cpu"} if direction == "port_to_jax"
                                             else {}))
    np.testing.assert_array_equal(np.asarray(again.query(q)), want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_promoted_beam_form_loads_across(tmp_path, writer):
    # A v14 engine that promoted to the octree beam index saves the beam
    # frontier; NNEngine.load(14) tells the two forms apart by their keys.
    q, r = make_dataset(3, 256, 16384, seed=33, clustered=True)
    path = str(tmp_path / "beam.npz")
    if writer == "port":
        eng = nns_tpu_torch.NNEngine(14, device="cpu").build(r)
        eng._promote_to_beam()
        assert isinstance(eng._built, BeamIndex)
    else:
        eng = nns_tpu.NNEngine(14).build(r)
        eng._promote_to_beam()
        assert isinstance(eng._built, JBeamIndex)
    eng.save(path)
    ours = nns_tpu_torch.NNEngine.load(path, 14, device="cpu")
    theirs = nns_tpu.NNEngine.load(path, 14)
    assert isinstance(ours._built, BeamIndex) and isinstance(theirs._built, JBeamIndex)
    for e in (ours, theirs):
        assert_exact(np.asarray(e.query(q)), q, r)
    d2, idx = ours.query_topk(q, 8)
    jd2, _ = theirs.query_topk(q, 8)
    np.testing.assert_allclose(d2, jd2, rtol=1e-6)


@pytest.mark.parametrize("version", [4, 9, "auto"])
def test_save_refuses_what_jax_refuses(tmp_path, version):
    # Brute-force engines hold no index: both packages refuse to save them
    # (v9 included), and load() takes only v10-v14.
    k = 16 if version == 9 else 5
    _, r = make_dataset(k, 1, 4096, seed=34)
    path = str(tmp_path / "x.npz")
    for eng in (nns_tpu_torch.NNEngine(version, device="cpu").build(r),
                nns_tpu.NNEngine(version).build(r)):
        with pytest.raises(ValueError, match="tree/index"):
            eng.save(path)
    with pytest.raises(ValueError):
        nns_tpu_torch.NNEngine.load(path, 4 if version == "auto" else version, device="cpu")


def test_save_refuses_fused_form_of_tree_versions(tmp_path):
    # v13 at k != 3 stages the fused engine, which is not serializable.
    _, r = make_dataset(5, 1, 2048, seed=35)
    eng = nns_tpu_torch.NNEngine(13, device="cpu").build(r)
    with pytest.raises(ValueError, match="not serializable"):
        eng.save(str(tmp_path / "x.npz"))
    with pytest.raises(ValueError, match="explicit version"):
        nns_tpu_torch.NNEngine.load(str(tmp_path / "x.npz"), "auto", device="cpu")
