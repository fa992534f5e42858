"""Host utilities of the port: checkpoint loading and writing, the weight
bridge, the tiler, the TIFF reader and writer (``tiff``), whole-slide
inference (``wsi``), and ``luma_u8`` (the port's own copy of
deepliif_tpu.utils.luma_u8)."""

from __future__ import annotations

import numpy as np


def luma_u8(rgb):
    """ITU-R 601 luma with truncation — PIL 'L' conversion semantics."""
    a = rgb.astype(np.uint32)
    return ((a[..., 0] * 299 + a[..., 1] * 587 + a[..., 2] * 114) // 1000).astype(np.uint8)
