"""Background / empty-tile heuristics: the port's own copy of
deepliif_tpu/utils/background.py.

Parity with the reference (util/__init__.py:334-497): NLMeans-denoised
channel-similarity masks for background color/area, multi-Otsu tile contrast
adjustment, and the training-time background-color inference that scans
training rows for empty 32px tiles (stored into train_opt as
``background_colors`` and used by the inference empty-tile short-circuit).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from . import image_variance_gray
from ..postprocessing import imadjust


def _denoise(img):
    import cv2
    return cv2.fastNlMeansDenoisingColored(np.asarray(img), None, 10, 10, 7, 21)


def calculate_background_mean_value(img):
    """Mean RGB over channel-similar (gray-ish) pixels after NLMeans."""
    if hasattr(img, 'convert'):
        img = img.convert('RGB')   # NLMeans asserts 3-channel uint8
    a = _denoise(img).astype(float)
    t = 15
    d01 = np.abs(a[..., 0] - a[..., 1])
    d02 = np.abs(a[..., 0] - a[..., 2])
    d12 = np.abs(a[..., 1] - a[..., 2])
    back = (d01 < t) & (d02 < t) & (d12 < t)
    if not back.any():
        return np.asarray(a.reshape(-1, 3).mean(0), np.uint8)
    return np.mean(a[back], axis=0).astype(np.uint8)


def calculate_background_area(img):
    """Percent of pixels that look like background."""
    total = img.width * img.height
    a = _denoise(img.convert('RGB')).astype(float)
    t = 15
    d01 = np.abs(a[..., 0] - a[..., 1])
    d02 = np.abs(a[..., 0] - a[..., 2])
    d12 = np.abs(a[..., 1] - a[..., 2])
    back = (d01 < t) & (d02 < t) & (d12 < t)
    fore = ((a[..., 2] - a[..., 0]) > 5) & ((a[..., 2] - a[..., 1]) > 5)
    n_back = int(np.count_nonzero(back & ~fore))
    return int(n_back / total * 100) if total > 0 else 0


def threshold_multiotsu(image, classes=3):
    """Two-threshold multi-Otsu (skimage-equivalent; skimage is not in this
    environment): exhaustive maximization of between-class variance over the
    histogram."""
    hist = np.bincount(image.ravel(), minlength=256).astype(np.float64)
    total = hist.sum()
    p = hist / total
    levels = np.arange(256, dtype=np.float64)
    # prefix sums for O(1) class stats
    w_cum = np.cumsum(p)
    m_cum = np.cumsum(p * levels)

    def stats(lo, hi):  # [lo, hi] inclusive
        w = w_cum[hi] - (w_cum[lo - 1] if lo > 0 else 0.0)
        m = m_cum[hi] - (m_cum[lo - 1] if lo > 0 else 0.0)
        return w, m

    best, best_t = -1.0, (85, 170)
    for t1 in range(1, 254):
        w0, m0 = stats(0, t1)
        if w0 == 0:
            continue
        for t2 in range(t1 + 1, 255):
            w1, m1 = stats(t1 + 1, t2)
            w2, m2 = stats(t2 + 1, 255)
            if w1 == 0 or w2 == 0:
                continue
            var = (m0 * m0 / w0) + (m1 * m1 / w1) + (m2 * m2 / w2)
            if var > best:
                best, best_t = var, (t1, t2)
    return np.asarray(best_t)


def adjust_background_tile(img):
    """Contrast-adjust a background tile (reference util/__init__.py:361-377)."""
    image = np.asarray(img.convert('L'))
    if len(np.unique(image)) > 3:
        thresholds = threshold_multiotsu(image)
        regions = np.digitize(image, bins=thresholds)
        dark = image[regions == 0]
        if dark.size:   # empty when the darkest Otsu class sits ON t1
            image = imadjust(image.astype(float),
                             np.mean(dark) / 20, 0, 255).astype(np.uint8)
    return Image.fromarray(image).convert('RGB')


def infer_background_colors(dir_data, sample_size=5, input_no=1,
                            modalities_no=4, seg_no=1, tile_size=32,
                            return_list=False):
    """Scan training rows for tiles that are empty in the seg modalities and
    average the corresponding modality colors (reference :380-418)."""
    fns = sorted(x for x in os.listdir(dir_data) if x.endswith('.png'))
    sample_size = min(sample_size, len(fns))
    background_colors = {}
    count = 0
    w = h = num_img = None
    for fn in fns:
        if count >= sample_size:
            break
        img = Image.open(os.path.join(dir_data, fn))
        if w is None:
            w, h = img.size
            num_img = int(img.size[0] / img.size[1])
        per_img = infer_background_colors_for_img(
            img, input_no=input_no, modalities_no=modalities_no,
            seg_no=seg_no, tile_size=tile_size, w=w, h=h, num_img=num_img)
        if per_img is not None:
            count += 1
            for mod_id, rgb in per_img.items():
                background_colors.setdefault(mod_id, []).append(rgb)
    if count == 0:
        print('no empty tiles found for background color estimation')
        return None
    background_colors = {k: np.mean(v, axis=0).astype(np.uint8)
                         for k, v in background_colors.items()}
    if return_list:
        return [tuple(int(c) for c in v) for v in background_colors.values()]
    return background_colors


def infer_background_colors_for_img(img, input_no=1, modalities_no=4,
                                    seg_no=1, tile_size=32, w=None, h=None,
                                    num_img=None):
    if w is None:
        w, h = img.size
        num_img = int(img.size[0] / img.size[1])

    def tile_is_empty(t):
        return image_variance_gray(t) < 9

    l_box = []
    for i in range(num_img - seg_no, num_img):
        img_mod = img.crop((h * i, 0, h * (i + 1), h))
        boxes = []
        for x in range(0, h, tile_size):
            for y in range(0, h, tile_size):
                box = (x, y, x + tile_size, y + tile_size)
                if tile_is_empty(img_mod.crop(box)):
                    boxes.append(box)
        l_box.append(boxes)

    if len(l_box) > 1:
        final = set(l_box[0])
        for l in l_box[1:]:
            final &= set(l)
        final = sorted(final)
    else:
        final = l_box[0]
    if not final:
        return None

    colors = {}
    for i in range(input_no, modalities_no + input_no):
        img_mod = img.crop((h * i, 0, h * (i + 1), h))
        tiles = [np.asarray(img_mod.crop(b)) for b in final]
        avg = np.mean(np.stack(tiles), axis=0)
        colors[i] = np.mean(avg, axis=(0, 1)).astype(np.uint8)
    return colors
