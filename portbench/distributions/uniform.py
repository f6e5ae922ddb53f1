"""Uniform float32 points over a box: the upstream's getRand/getSample
(NNS-CUDA main.cu:10-35, uniform [0, 1]) and the uniform branch of
``make_dataset``, copied so that the benchmark imports nothing of the port.
For one seed the points over [0, 1] are byte-equal to ``make_dataset``'s
refs."""

from __future__ import annotations

import numpy as np


def points(count: int, k: int, seed: int, params: dict) -> np.ndarray:
    """(count, k) float32, uniform over ``params["box"]`` = [lo, hi] in
    every dimension (default [0, 1]), from ``numpy.random.default_rng(seed)``."""
    lo, hi = params.get("box", (0.0, 1.0))
    x = np.random.default_rng(seed).random((count, k), dtype=np.float32)
    if (lo, hi) != (0.0, 1.0):
        x = (x * (hi - lo) + lo).astype(np.float32)
    return x
