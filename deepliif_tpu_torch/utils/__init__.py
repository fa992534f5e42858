"""Host utilities of the port: checkpoint loading and writing, the weight
bridge, the tiler, the TIFF reader and writer (``tiff``), whole-slide
inference (``wsi``), training's visualizer and background heuristics, and
the port's own copies of deepliif_tpu.utils ``luma_u8``, ``tensor2im`` and
``image_variance_gray``."""

from __future__ import annotations

import numpy as np


def luma_u8(rgb):
    """ITU-R 601 luma with truncation — PIL 'L' conversion semantics."""
    a = rgb.astype(np.uint32)
    return ((a[..., 0] * 299 + a[..., 1] * 587 + a[..., 2] * 114) // 1000).astype(np.uint8)


def tensor2im(arr):
    """Convert a network output (B,H,W,C) or (H,W,C) in [-1,1] to uint8 HWC.

    Matches the reference tensor2im (util/util.py:117-135): (x+1)/2*255 with a
    truncating cast, first batch element only, grayscale tiled to RGB.
    """
    a = np.asarray(arr, np.float32)
    if a.ndim == 4:
        a = a[0]
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    return ((a + 1) / 2.0 * 255.0).astype(np.uint8)


def image_variance_gray(img):
    """Grayscale variance excluding pure 0/255 pixels (reference
    util/__init__.py:479-487): the empty-tile short-circuit uses
    variance < 9 -> background."""
    if hasattr(img, 'convert'):
        px = np.asarray(img if img.mode == 'L' else img.convert('L'))
    else:
        px = luma_u8(np.asarray(img))
    val = px[(px != 255) & (px != 0)]
    if val.size == 0:
        return 0.0
    return float(np.var(val))
