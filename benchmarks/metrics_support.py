"""What several metric readers share."""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from benchmarks import roofline
from benchmarks.common import ROOT


@lru_cache(maxsize=None)
def _kept(path: str) -> float:
    with np.load(path) as f:
        return roofline.kept_tiles(f["gru_a_mask"])


def kept_tiles(ctx) -> float:
    """Share of GRU-A's recurrent tiles the cell's checkpoint keeps."""
    return _kept(str(ROOT / ctx["config"]["ini"]["Decoding"]
                     ["vocoder_weights"]))
