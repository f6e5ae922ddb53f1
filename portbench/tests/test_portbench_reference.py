"""The plain float64 reference, the comparison and the TF32 control,
against a hand brute force on tiny sets."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.distributions import uniform


def _brute(queries, refs):
    """Least squared distance per query, by Python loops in float64."""
    out = []
    for q in queries.astype(np.float64):
        best = np.inf
        for r in refs.astype(np.float64):
            d = 0.0
            for a, b in zip(q, r):
                d += (a - b) ** 2
            best = min(best, d)
        out.append(best)
    return np.array(out)


@pytest.mark.parametrize("k", [3, 16])
def test_nearest_d2_equals_a_hand_brute_force(k):
    refs = uniform.points(97, k, 5, {})
    queries = uniform.points(13, k, 6, {"box": [-0.5, 1.5]})
    got = reference.nearest_d2(queries, refs, "cpu").numpy()
    assert np.array_equal(got, _brute(queries, refs))


def test_nearest_d2_tiles_cover_every_pair(monkeypatch):
    monkeypatch.setitem(reference._BUDGET, "cpu", 5)  # 1 x 5 tiles, ragged
    refs = uniform.points(23, 3, 1, {})
    queries = uniform.points(7, 3, 2, {})
    got = reference.nearest_d2(queries, refs, "cpu").numpy()
    assert np.array_equal(got, _brute(queries, refs))


def test_misses_accepts_every_member_of_a_tie():
    refs = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 0], [-1, 0, 0], [5, 5, 5]], np.float32)
    q = np.zeros((3, 3), np.float32)
    q[:, 0] = [0.5, 0.5, 0.5]  # equidistant from refs 0, 1 and 2
    assert reference.misses(q, refs, np.array([0, 1, 2]), "cpu") == 0
    assert reference.misses(q, refs, np.array([0, 3, 4]), "cpu") == 2


def test_misses_counts_wrong_and_out_of_range_answers():
    refs = uniform.points(200, 3, 9, {})
    queries = uniform.points(50, 3, 10, {})
    truth = np.array([np.argmin(((refs.astype(np.float64) - q) ** 2).sum(1))
                      for q in queries.astype(np.float64)])
    assert reference.misses(queries, refs, truth, "cpu") == 0
    bad = truth.copy()
    bad[[0, 7]] = (bad[[0, 7]] + 1) % 200
    bad[9], bad[11] = -1, 200
    assert reference.misses(queries, refs, bad, "cpu") == 4


def test_the_float32_band():
    """A point within float32 noise of the least distance counts; one just
    outside the band misses."""
    q = np.array([[0.5, 0, 0]], np.float32)
    refs = np.array([[0, 0, 0], [1 + 2 ** -23, 0, 0]], np.float32)
    # (0.5 + 2^-23)^2 = 0.25 (1 + 2^-21 + ...), inside band(3) = 12 x 2^-24.
    assert 2.0 ** -21 < reference.band(3)
    assert reference.misses(q, refs, np.array([1]), "cpu") == 0
    refs[1, 0] = 1 + 2 ** -21  # 0.25 (1 + 2^-19): outside
    assert reference.misses(q, refs, np.array([1]), "cpu") == 1


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 2 + 2 ** -20,
                      -(one + ulp * 0.49), 0.0], dtype=torch.float32)
    got = reference.round_tf32(x).tolist()
    assert got == [one, one + 2 * ulp, one + ulp, -one, 0.0]
    y = reference.round_tf32(torch.rand(1000))
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)


@pytest.mark.parametrize("k", [3, 16])
def test_control_misses_where_the_reference_does_not(k):
    """The control at a size a test run holds: TF32 answers miss."""
    refs = uniform.points(1 << 16, k, 11, {})
    queries = uniform.points(2000, k, 12, {})
    assert reference.misses(queries, refs, reference.control_min_idx(queries, refs, "cpu"),
                            "cpu") > 0
