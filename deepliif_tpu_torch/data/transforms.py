"""Image transforms for training data: the port's own copy of
deepliif_tpu/data/transforms.py.

Parity with the reference get_params/get_transform
(reference deepliif/data/base_dataset.py:62-159): resize/scale_width,
shared random crop + horizontal flip across the A/B tiles of one example,
then ToTensor + Normalize(0.5, 0.5) -> float32 in [-1, 1] (we keep NHWC).
"""

from __future__ import annotations

import random

import numpy as np
from PIL import Image


def get_params(preprocess, load_size, crop_size, size, rng=None):
    rng = rng or random
    w, h = size
    new_w, new_h = w, h
    if preprocess == 'resize_and_crop':
        new_h = new_w = load_size
    elif preprocess == 'scale_width_and_crop':
        new_w = load_size
        new_h = load_size * h // w
    x = rng.randint(0, max(0, new_w - crop_size))
    y = rng.randint(0, max(0, new_h - crop_size))
    flip = rng.random() > 0.5
    return {'crop_pos': (x, y), 'flip': flip}


def _make_power_2(img, base=4, method=Image.BICUBIC):
    ow, oh = img.size
    w = int(round(ow / base) * base)
    h = int(round(oh / base) * base)
    if (w, h) == (ow, oh):
        return img
    return img.resize((w, h), method)


def _scale_width(img, target_size, crop_size, method=Image.BICUBIC):
    ow, oh = img.size
    if ow == target_size and oh >= crop_size:
        return img
    w = target_size
    h = int(max(target_size * oh / ow, crop_size))
    return img.resize((w, h), method)


def apply_transform(img, preprocess, load_size, crop_size, no_flip,
                    params=None, grayscale=False, method=Image.BICUBIC,
                    normalize=True):
    """Apply the deterministic transform chain; returns float32 HWC in [-1,1]
    (or a PIL image if normalize=False)."""
    if grayscale:
        img = img.convert('L')
    preprocess = preprocess or 'none'
    if 'resize' in preprocess:
        img = img.resize((load_size, load_size), method)
    elif 'scale_width' in preprocess:
        img = _scale_width(img, load_size, crop_size, method)
    if 'crop' in preprocess:
        x, y = params['crop_pos'] if params else (0, 0)
        ow, oh = img.size
        if ow > crop_size or oh > crop_size:
            img = img.crop((x, y, x + crop_size, y + crop_size))
    if preprocess == 'none':
        img = _make_power_2(img)
    if not no_flip and params and params['flip']:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if not normalize:
        return img
    a = np.asarray(img, np.float32) / 255.0
    if a.ndim == 2:
        a = a[..., None]
    return (a - 0.5) / 0.5
