"""The serving paths' spans and counters (``nns_tpu_torch.utils.spans``) on
CPU torch, for the v14 supercell engine and the v9 expansion engine behind
``NNEngine``: with no profiler no range is built; under
``torch.profiler`` each call records its spans, in order, nested in its
``nns.api.*`` span, and answers exactly as without; the row counters are
the certificates' own counts, and the copy counters stay 0 off a CUDA
device."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nns_tpu_torch
from nns_tpu_torch.config import DEFAULT_ENGINE_CONFIG
from nns_tpu_torch.data import make_dataset
from nns_tpu_torch.utils import spans

# version: (k, n). Small, so that the plain CPU kernels answer in seconds.
ENGINES = {14: (3, 8192), 9: (16, 2048)}
ROWS = 200
# Rows of the last batch moved out of the refs' [0, 1] box: v14's halo
# certificate fails on them, and v9's band widens with the largest |q|.
FAR = 8


def _engine(version, config=None):
    k, n = ENGINES[version]
    _, refs = make_dataset(k, 1, n, seed=19)
    eng = nns_tpu_torch.NNEngine(version, config=config, device="cpu").build(refs)
    rng = np.random.default_rng(23)
    batches = [rng.random((ROWS, k), dtype=np.float32) for _ in range(3)]
    batches[-1][:FAR] += 1.5 if version == 14 else 40.0
    return eng, batches


def _spans(prof):
    """The program's spans of a finished profile: (name, start, end),
    in order of start, outer before inner."""
    got = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("nns.")]
    return sorted(got, key=lambda s: (s[1], -s[2]))


def _expected(version, entry, eng, batches):
    """The spans one call of ``entry`` records, from the engine's own
    certificates on the same batches."""
    built = eng._built
    if version == 14:
        def uncertified(b):
            return not built.query_with_flags(b)[1].all()

        if entry == "query_many":
            # The drain bins the whole queue on the device: one bin span,
            # no host sort.
            names = ["nns.cells.bin", "nns.cells.device", "nns.cells.download"]
            for b in batches:
                names += ["nns.cells.unstage"] + ["nns.cells.exact_rows"] * uncertified(b)
            return ["nns.api.query_many"] + names
        names = ["nns.api.query", "nns.cells.stage", "nns.cells.device", "nns.cells.unstage",
                 "nns.cells.download", "nns.cells.unstage"]
        return names + ["nns.cells.exact_rows"] * uncertified(batches[-1])
    q = np.concatenate(batches) if entry == "query_many" else batches[-1]
    refine = ["nns.mxu.band_refine"] * (not built.query_min_idx_cert(q)[2].all())
    names = ["nns.api.query", "nns.mxu.stage_queries", "nns.mxu.phase12", "nns.mxu.certify",
             *refine, "nns.mxu.download"]
    # query_many answers the concatenated queue through query.
    return ["nns.api.query_many"] * (entry == "query_many") + names


def _call(eng, entry, batches):
    return eng.query_many(batches) if entry == "query_many" else [eng.query(batches[-1])]


@pytest.mark.parametrize("version", list(ENGINES))
def test_without_a_profiler_no_range_is_built(version, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert spans.span("nns.api.query") is spans.span("nns.cells.stage")
    built = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: built.append(name))
    eng, batches = _engine(version)
    eng.query_many(batches)
    eng.query(batches[-1])
    assert built == []


@pytest.mark.parametrize("entry", ["query_many", "query"])
@pytest.mark.parametrize("version", list(ENGINES))
def test_a_profiled_call_records_its_spans_in_order(version, entry):
    eng, batches = _engine(version)
    plain = _call(eng, entry, batches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _call(eng, entry, batches)
    for a, b in zip(plain, traced, strict=True):
        np.testing.assert_array_equal(a, b)
    got = _spans(prof)
    names = [name for name, _, _ in got]
    # The full scan follows the band refine only where the refine refuses.
    if version == 9 and "nns.mxu.full_scan" in names:
        assert names[names.index("nns.mxu.full_scan") - 1] == "nns.mxu.band_refine"
        names.remove("nns.mxu.full_scan")
    assert names == _expected(version, entry, eng, batches)
    _, t0, t1 = got[0]
    assert all(t0 <= s and e <= t1 for _, s, e in got[1:])


@pytest.mark.parametrize("version", list(ENGINES))
def test_row_counts_are_the_certificates_and_copies_stay_zero_on_cpu(version):
    eng, batches = _engine(version)
    before = dict(spans.COUNTS)
    eng.query_many(batches)
    eng.query(batches[-1])
    got = {name: spans.COUNTS[name] - before[name] for name in spans.COUNTS}
    if version == 14:
        oks = [eng._built.query_with_flags(b)[1] for b in batches + batches[-1:]]
        mine, other = "cells", "mxu"
    else:
        oks = [eng._built.query_min_idx_cert(q)[2]
               for q in (np.concatenate(batches), batches[-1])]
        mine, other = "mxu", "cells"
    rows, certified = sum(len(ok) for ok in oks), sum(int(ok.sum()) for ok in oks)
    assert got[f"{mine}.rows"] == rows == ROWS * (len(batches) + 1)
    assert got[f"{mine}.certified_rows"] == certified < rows
    assert got[f"{other}.rows"] == got[f"{other}.certified_rows"] == 0
    assert got["copy.bytes_up"] == got["copy.bytes_down"] == 0


@pytest.mark.parametrize("version", list(ENGINES))
def test_an_index_change_is_a_promote_span(version):
    """v14 promotes to the beam index after a batch that its certificate
    misses; v9 probes the KD beam index once enough queries have passed."""
    config = dataclasses.replace(DEFAULT_ENGINE_CONFIG, hk_probe_after=ROWS,
                                 hk_promote_n_min=ENGINES[9][1])
    eng, batches = _engine(version, config)
    if version == 14:
        batches[-1] += 1.5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.query(batches[-1])
    names = [name for name, _, _ in _spans(prof)]
    assert names[0] == "nns.api.query" and names.count("nns.api.promote") == 1
    assert names.index("nns.api.promote") > names.index(
        "nns.cells.exact_rows" if version == 14 else "nns.mxu.download")


def test_copies_count_on_a_cuda_device_only():
    before = dict(spans.COUNTS)
    spans.count_copy("up", 20, torch.device("cpu"))
    spans.count_copy("up", 20, torch.device("cuda"))
    spans.count_copy("down", 8, torch.device("cuda", 0))
    assert spans.COUNTS["copy.bytes_up"] - before["copy.bytes_up"] == 20
    assert spans.COUNTS["copy.bytes_down"] - before["copy.bytes_down"] == 8
    spans.reset_counts()
    assert set(spans.COUNTS.values()) == {0}
