"""Rounding to bfloat16 for the controls: the nearest bfloat16 value of
each element (ties to even), returned in the array's own type."""

from __future__ import annotations

import numpy as np


def round_bf16(a):
    """Each element of ``a`` rounded to bfloat16; scalars and arrays."""
    x = np.asarray(a, np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32)
    return out.astype(np.asarray(a).dtype if np.asarray(a).dtype.kind == "f"
                      else np.float32)
