"""Query rows at the PAD_SENTINEL corner, shared by the CPU and the card's
tests of the v14 sentinel mask (and by ``chip_smoke.py``). It imports
neither jax nor nns_tpu, so ``tests/test_torch_gpu.py`` may use it."""

import numpy as np

from nns_tpu_torch.kernels.cell_list import _SENTINEL_MARGIN
from nns_tpu_torch.kernels.layouts import PAD_SENTINEL


def corner_rows(eng) -> np.ndarray:
    """Rows at the PAD_SENTINEL corner: one, or each, coordinate at
    PAD_SENTINEL - 2 halo, at its margin, one f32 ulp either side of them,
    or at the corner itself, the others at the corner."""
    sent = np.float32(PAD_SENTINEL)
    edge = np.float32(PAD_SENTINEL - 2.0 * eng.halo)
    margin = PAD_SENTINEL - 2.0 * eng.halo - _SENTINEL_MARGIN
    lows = [edge, np.nextafter(edge, np.float32(np.inf)), np.nextafter(edge, np.float32(0)),
            np.float32(margin), np.nextafter(np.float32(margin), np.float32(0)),
            np.nextafter(np.float32(margin), np.float32(np.inf)), sent]
    return np.array([[x, sent, sent] for x in lows] + [[x, x, x] for x in lows]
                    + [[sent, x, sent] for x in lows], dtype=np.float32)
