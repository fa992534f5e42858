"""int8 quantization: weights, activations, the scope and the
activation-scale file (``--precision int8``, scopes 'all' and
'resblocks').

Port of deepliif_tpu/nets/layers.py ``quantize_conv_int8``,
``int8_scope_predicate``, the min_ch gate and the per-input-channel folding
of ``quantize_conv_tree_int8``, ``_quant_act`` / ``_quant_act_int8`` and
the ``_int8_ok`` gate, and of deepliif_tpu/models/__init__.py
``_load_act_scales``. Weights are HWIO (KH, KW, C_in, C_out) float32, the
JAX layout (conv-transposes spatially flipped,
``utils.checkpoints.weight_to_hwio``), so the quantized tensors equal the
JAX package's bit for bit on the same weights.

The JAX package reads its scope from ``DEEPLIIF_INT8_SCOPE``; here it is an
explicit argument and no environment variable is read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

SCOPES = ('all', 'resblocks')
# convs with fewer input or output channels stay float (the heads fed by
# 3-channel images, the 3-channel tails): quantize_conv_tree_int8's min_ch
MIN_CH = 16
# the dynamic route's largest conv input, H * W: past it the conv runs
# float (layers._INT8_MAX_SPATIAL; static scales have no limit). It
# decides which convs run int8, so it is part of the function computed
INT8_MAX_SPATIAL = 256 * 256


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


@dataclasses.dataclass(frozen=True)
class Int8Conv:
    """One quantized conv, what ``nets.layers.conv2d`` /
    ``conv_transpose2d`` take in place of a weight: ``w`` the weight in the
    compute dtype and torch layout (the float route past the dynamic
    spatial gate), ``w_q`` (KH, KW, C_in, C_out) int8 HWIO, ``w_s``
    (C_out,) float32; static scales: ``a_s`` (scalar or (C_in,) float32)
    and ``inv_a``, 1 / a_s in the compute dtype shaped to broadcast over
    NCHW; dynamic: both None."""
    w: torch.Tensor
    w_q: torch.Tensor
    w_s: torch.Tensor
    a_s: torch.Tensor | None = None
    inv_a: torch.Tensor | None = None

    @property
    def static(self):
        return self.a_s is not None


def quantize_conv(w, w_hwio, scale, dtype):
    """Int8Conv of one conv: ``w`` its torch weight, ``w_hwio`` the same in
    the JAX layout (float32), ``scale`` the calibrated max |x| of its input
    (static) or None (dynamic), ``dtype`` the compute dtype."""
    if scale is None:
        w_q, w_s = quantize_conv_int8(w_hwio)
        return Int8Conv(w.to(dtype), w_q, w_s)
    w_q, w_s, a_s = quantize_conv_int8_static(w_hwio, scale)
    # 1 / a_s in float32, rounded to the compute dtype (layers.py _quant_act)
    inv = (1.0 / a_s).to(dtype)
    return Int8Conv(w.to(dtype), w_q, w_s, a_s,
                    inv.reshape(1, -1, 1, 1) if inv.dim() else inv)


def int8_ok(x, static):
    """The JAX package's ``_int8_ok`` on an NCHW conv input: static scales
    always, dynamic ones up to INT8_MAX_SPATIAL pixels."""
    return static or x.shape[2] * x.shape[3] <= INT8_MAX_SPATIAL


def quant_act_static(x, inv_a):
    """Static activation quantization (layers.py ``_quant_act``): x (N, C,
    H, W) times ``inv_a`` (Int8Conv.inv_a, in x.dtype), the product rounded
    to x.dtype, then round half to even and clip to +-127; int8 in x's
    memory format."""
    return torch.clamp(torch.round(x * inv_a), -127, 127).to(torch.int8)


def quant_act_dynamic(x):
    """Dynamic per-sample activation quantization (layers.py
    ``_quant_act_int8``): s = max(max |x| over (C, H, W) in float32 / 127,
    1e-12); q = clip(round(x / bf16(s)), +-127) with the division in
    x.dtype. Returns (q int8 in x's memory format, s (N,) float32)."""
    s = torch.clamp(_div127(x.float().abs().amax(dim=(1, 2, 3))), min=1e-12)
    q = torch.clamp(torch.round(x / s.to(x.dtype)[:, None, None, None]),
                    -127, 127).to(torch.int8)
    return q, s


def save_act_scales(model_dir, scales, pct, n_tiles):
    """Write ``act_scales.json`` ({'scales', 'pct', 'n_tiles'}, the JAX
    package's format). Returns False, writing nothing, when the model dir
    cannot be written: the scales then serve this session alone."""
    try:
        with open(os.path.join(model_dir, 'act_scales.json'), 'w') as f:
            json.dump({'scales': scales, 'pct': pct, 'n_tiles': int(n_tiles)},
                      f, indent=1)
    except OSError:
        return False
    return True
