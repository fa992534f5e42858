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


# the input channels of one step of the conv_s8 kernel (csrc/conv_s8.cu)
S8_KC = 32


def s8_block_n(cout):
    """The output channels of one conv_s8 item (csrc/conv_s8.cu block_n):
    64 or 128 by C_out."""
    return 64 if cout <= 64 else 128


def s8_column_channel(n, bn):
    """The output channel (within its block of ``bn``) of the GEMM column
    ``n`` of the conv_s8 kernel: the wgmma accumulators give thread t of a
    quad columns 8 v + 2 t + e, and these are channels t bn / 4 + 2 v + e."""
    return (n % 8 // 2) * (bn // 4) + 2 * (n // 8) + n % 2


def pack_s8_weights(w_q):
    """The B operand image of ``csrc/conv_s8.cu`` from an HWIO int8 kernel
    (KH, KW, C_in, C_out): (KH, KW, ceil(C_in / 32), C_out_pad * 32) int8,
    C_out_pad = C_out rounded up to ``s8_block_n``. Per tap and 32-channel
    step, every output channel's 32 input channels as K-major core matrices
    (the wgmma descriptor's layout without swizzle): channel ci = 16 kc + e
    of the block's column n at byte (n / 8) 256 + kc 128 + (n % 8) 16 + e;
    zeros past C_in and C_out. A block of BN columns is then BN x 32
    contiguous bytes: one bulk copy per step. Column n of block b holds
    output channel b BN + ``s8_column_channel(n, BN)``, so that each thread
    of the wgmma accumulator layout holds BN / 4 consecutive channels."""
    kh, kw, cin, cout = w_q.shape
    nkc = -(-cin // S8_KC)
    bn = s8_block_n(cout)
    cp = -(-cout // bn) * bn
    w = torch.zeros((kh, kw, nkc * S8_KC, cp), dtype=torch.int8,
                    device=w_q.device)
    w[:, :, :cin, :cout] = w_q
    n = torch.arange(bn)
    order = (torch.arange(cp // bn)[:, None] * bn
             + s8_column_channel(n, bn)[None]).reshape(-1)
    w = w[..., order.to(w.device)]
    # (kh, kw, step, kc, e, co / 8, co % 8) -> (kh, kw, step, co / 8, kc,
    # co % 8, e)
    w = w.reshape(kh, kw, nkc, 2, 16, cp // 8, 8).permute(0, 1, 2, 5, 3, 6, 4)
    return w.contiguous().reshape(kh, kw, nkc, cp * S8_KC)


@dataclasses.dataclass(frozen=True)
class Int8Conv:
    """One quantized conv, what ``nets.layers.conv2d`` /
    ``conv_transpose2d`` take in place of a weight: ``w`` the weight in the
    compute dtype and torch layout (the float route past the dynamic
    spatial gate), ``w_q`` (KH, KW, C_in, C_out) int8 HWIO, ``w_s``
    (C_out,) float32, ``w_pk`` w_q packed for the conv_s8 kernel
    (``pack_s8_weights``, once per session); static scales: ``a_s``
    (scalar or (C_in,) float32), ``inv_a``, 1 / a_s in the compute dtype
    shaped to broadcast over NCHW, and ``inv_c``, the same per input channel
    ((C_in,), what the kernel reads); dynamic: the three None."""
    w: torch.Tensor
    w_q: torch.Tensor
    w_s: torch.Tensor
    w_pk: torch.Tensor
    a_s: torch.Tensor | None = None
    inv_a: torch.Tensor | None = None
    inv_c: torch.Tensor | None = None

    @property
    def static(self):
        return self.a_s is not None


def quantize_conv(w, w_hwio, scale, dtype):
    """Int8Conv of one conv: ``w`` its torch weight, ``w_hwio`` the same in
    the JAX layout (float32), ``scale`` the calibrated max |x| of its input
    (static) or None (dynamic), ``dtype`` the compute dtype."""
    if scale is None:
        w_q, w_s = quantize_conv_int8(w_hwio)
        return Int8Conv(w.to(dtype), w_q, w_s, pack_s8_weights(w_q))
    w_q, w_s, a_s = quantize_conv_int8_static(w_hwio, scale)
    # 1 / a_s in float32, rounded to the compute dtype (layers.py _quant_act)
    inv = (1.0 / a_s).to(dtype)
    cin = w_hwio.shape[2]
    return Int8Conv(w.to(dtype), w_q, w_s, pack_s8_weights(w_q), a_s,
                    inv.reshape(1, -1, 1, 1) if inv.dim() else inv,
                    inv.reshape(-1).expand(cin).contiguous())


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
