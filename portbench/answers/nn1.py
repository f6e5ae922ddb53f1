"""Exact 1-NN answers: one ref index per query, judged by the plain
float64 reference under the configurations' stated guarantee
(``portbench.reference``); the control is the reference one precision
lower (TF32)."""

import numpy as np

from portbench import reference


def well_formed(answer, rows: int) -> bool:
    """An answer to a batch of ``rows`` queries: ``rows`` integer indices."""
    a = np.asarray(answer)
    return a.shape == (rows,) and np.issubdtype(a.dtype, np.integer)


def misses(queries: np.ndarray, refs: np.ndarray, answer: np.ndarray, device) -> int:
    """Rows of ``answer`` that are no nearest neighbour of ``queries``."""
    return reference.misses(queries, refs, answer, device)


def control(queries: np.ndarray, refs: np.ndarray, device) -> np.ndarray:
    """The control's answers to ``queries``."""
    return reference.control_min_idx(queries, refs, device)
