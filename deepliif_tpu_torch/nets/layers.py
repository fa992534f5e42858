"""Functional layer primitives for inference, NCHW (PyTorch's layout).

Port of the parts of deepliif_tpu/nets/layers.py that inference needs. The
nets of this package keep the reference torch layout (NCHW activations,
OIHW conv and IOHW conv-transpose weights) so reference state dicts load as
they are; deepliif_tpu.utils.torch_import converts between the two layouts
and ``deepliif_tpu_torch.utils.checkpoints`` is its inverse.

``conv2d_s2d`` and ``conv_transpose2d_s2d`` of the JAX package are TPU
lowering tricks for a tiny output-channel count; their counterpart here is
the plain conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x, weight, bias=None, stride=1, padding=0):
    """2D conv; ``padding`` int means symmetric zero pad (torch semantics)."""
    return F.conv2d(x, weight, bias, stride, padding)


def conv_transpose2d(x, weight, bias=None, stride=2, padding=1,
                     output_padding=1):
    """torch ConvTranspose2d with an IOHW weight:
    out = (in - 1) * stride - 2 * padding + k + output_padding."""
    return F.conv_transpose2d(x, weight, bias, stride, padding,
                              output_padding)


def pad2d(x, n, mode='zero'):
    if mode == 'zero':
        return F.pad(x, (n, n, n, n))
    if mode == 'reflect':
        return F.pad(x, (n, n, n, n), mode='reflect')
    raise NotImplementedError(f'padding [{mode}] not ported')


def batch_stat_norm(x, scale, bias, eps=1e-5):
    """BatchNorm2d with batch statistics (biased variance), affine, with the
    statistics taken per sample (over H, W): the reference inference
    semantics, where every tile is a batch of one with running stats
    disabled (deepliif_tpu ``batch_stat_norm(per_sample=True)``). Tiles of a
    batch must not couple through the norm, so ``nn.BatchNorm2d`` in train
    mode is never used for inference. Statistics are computed in float32."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    inv = torch.rsqrt(var + eps)
    s = inv * scale[None, :, None, None]
    b = bias[None, :, None, None] - mean * s
    return x * s.to(x.dtype) + b.to(x.dtype)


def relu(x):
    return torch.relu(x)


def leaky_relu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def tanh(x):
    return torch.tanh(x)
