"""int8 weight quantization and the activation-scale file, for the int8
trunk (``--precision int8 --int8-scope resblocks``).

Port of the parts of deepliif_tpu/nets/layers.py (``quantize_conv_int8``,
``int8_scope_predicate``, the per-input-channel folding of
``quantize_conv_tree_int8``) and deepliif_tpu/models/__init__.py
(``_load_act_scales``) that scope ``resblocks`` needs. Weights are HWIO
(3, 3, C_in, C_out) float32, the JAX layout, so the quantized tensors equal
the JAX package's bit for bit on the same weights.

The JAX package reads its scope from ``DEEPLIIF_INT8_SCOPE``; here it is an
explicit argument and no environment variable is read.
"""

from __future__ import annotations

import json
import os
import re

import torch

SCOPES = ('all', 'resblocks')


def _div127(t):
    """t / 127 as a true division on any device (on CUDA, tensor / python
    scalar multiplies by the reciprocal and can round one ulp apart from
    the JAX package's division)."""
    return t / torch.full_like(t, 127.0)


def quantize_conv_int8(w):
    """Per-output-channel symmetric int8 quantization of an HWIO kernel:
    s = max(max |w| over (kh, kw, ci) / 127, 1e-12), w_q = clip(round(w /
    s), +-127) with round half to even. Returns (w_q int8, s float32)."""
    w = w.float()
    m = w.abs().amax(dim=(0, 1, 2))
    s = torch.clamp(_div127(m), min=1e-12)
    w_q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return w_q, s


def act_scale(scale, cin):
    """Calibrated max |x| of a conv input (scalar or (cin,)) -> the
    activation quantize scale a_s = max(scale, 1e-12) / 127, float32,
    scalar or (cin,)."""
    a = _div127(torch.clamp(
        torch.as_tensor(scale, dtype=torch.float32).reshape(-1), min=1e-12))
    if a.numel() not in (1, cin):
        raise ValueError(f'act scale has {a.numel()} entries, conv has '
                         f'cin={cin}')
    return a[0] if a.numel() == 1 else a


def quantize_conv_int8_static(w, scale):
    """Static (calibrated) quantization of an HWIO kernel: the activation
    scale a_s (``act_scale``) is folded into the weights before weight
    quantization, w_eff[..., ci, co] = w[..., ci, co] * a_s[ci], so w_s is
    the complete per-output-channel dequant and a_s only quantizes the
    activation. Returns (w_q int8, w_s float32 (C_out,), a_s)."""
    a = act_scale(scale, w.shape[2])
    a_col = a.reshape(-1, 1).to(w.device)
    w_q, w_s = quantize_conv_int8(w.float() * a_col)
    return w_q, w_s, a.to(w.device)


def int8_scope_predicate(scope):
    """Quantization scope name -> predicate over a conv's param path
    ('G/res0_conv1', ...), or None for every conv ('all'). 'resblocks':
    only the ResNet-trunk resblock convs, the ones the fused int8 kernel
    runs."""
    if scope == 'all':
        return None
    if scope == 'resblocks':
        return lambda path: re.search(r'(^|/)res\d+_conv', path) is not None
    raise ValueError(f'unknown int8 scope [{scope}] '
                     f"(expected one of {SCOPES})")


def load_act_scales(model_dir):
    """``act_scales.json`` of a model dir -> {param path: float or list},
    or None when the file is absent. Keys are the JAX package's paths over
    its stacked param tree ('G/res{i}_conv{j}', ...): one scale vector is
    shared by every net of the group."""
    path = os.path.join(model_dir, 'act_scales.json')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    return {k: (v if isinstance(v, list) else float(v))
            for k, v in doc.get('scales', doc).items()}
