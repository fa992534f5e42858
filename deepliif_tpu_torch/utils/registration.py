"""Image co-registration utilities: the port's copy of
deepliif_tpu/utils/registration.py (host only, numpy and PIL).

The reference ships a Tk GUI for manual affine co-registration of IHC vs
mpIF images (/root/reference/Registration/Registration_App.py:22-281:
translate / scale / rotate controls applied to the moving image). This
module provides the same affine application programmatically plus an
automatic translation estimator (FFT phase correlation), usable headlessly
in pipelines; a GUI is intentionally out of scope for a TPU server image.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def apply_affine(img, translate=(0, 0), scale=1.0, rotate_deg=0.0,
                 output_size=None, resample=Image.BICUBIC):
    """Apply scale -> rotate -> translate to a PIL image (the manual
    controls of the reference registration app)."""
    img = img if hasattr(img, 'resize') else Image.fromarray(np.asarray(img))
    w, h = img.size
    out_w, out_h = output_size or (w, h)
    if scale != 1.0:
        img = img.resize((max(1, int(round(w * scale))),
                          max(1, int(round(h * scale)))), resample)
    if rotate_deg:
        img = img.rotate(rotate_deg, resample=Image.BICUBIC, expand=False)
    canvas = Image.new('RGB', (out_w, out_h))
    canvas.paste(img, (int(round(translate[0])), int(round(translate[1]))))
    return canvas


def register_translation(fixed, moving):
    """Estimate the (dx, dy) shift aligning ``moving`` to ``fixed`` via FFT
    phase correlation on grayscale intensities. Returns (dx, dy, score)."""
    f = np.asarray(Image.fromarray(np.asarray(fixed)).convert('L'), np.float64)
    m = np.asarray(Image.fromarray(np.asarray(moving)).convert('L'), np.float64)
    h = min(f.shape[0], m.shape[0])
    w = min(f.shape[1], m.shape[1])
    f, m = f[:h, :w], m[:h, :w]
    f = f - f.mean()
    m = m - m.mean()
    cross = np.fft.fft2(f) * np.conj(np.fft.fft2(m))
    denom = np.abs(cross)
    denom[denom == 0] = 1
    corr = np.fft.ifft2(cross / denom).real
    peak = np.unravel_index(np.argmax(corr), corr.shape)
    dy, dx = peak
    if dy > h // 2:
        dy -= h
    if dx > w // 2:
        dx -= w
    return int(dx), int(dy), float(corr[peak])


def register_pair(fixed, moving):
    """Auto-register: estimate translation and return the aligned moving
    image resampled onto the fixed frame."""
    dx, dy, score = register_translation(fixed, moving)
    fixed_img = Image.fromarray(np.asarray(fixed))
    aligned = apply_affine(Image.fromarray(np.asarray(moving)),
                           translate=(dx, dy), output_size=fixed_img.size)
    return aligned, {'dx': dx, 'dy': dy, 'score': score}
