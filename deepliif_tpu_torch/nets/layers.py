"""Functional layer primitives for inference, NCHW (PyTorch's layout).

Port of the parts of deepliif_tpu/nets/layers.py that inference needs. The
nets of this package keep the reference torch layout (NCHW activations,
OIHW conv and IOHW conv-transpose weights) so reference state dicts load as
they are; deepliif_tpu.utils.torch_import converts between the two layouts
and ``deepliif_tpu_torch.utils.checkpoints`` is its inverse.

Compute dtype: the nets keep float32 parameters and run in the dtype of
their input (float32 or bfloat16). Conv weights and biases are cast to it
once per weight version (``CastCache``); a conv bias is added after the
conv in the activation dtype, and norm statistics are taken in float32,
as the JAX package does.

``conv2d_s2d`` and ``conv_transpose2d_s2d`` of the JAX package are TPU
lowering tricks for a tiny output-channel count; their counterpart here is
the plain conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class CastCache:
    """Tensors of a net in a compute dtype, cast once per weight version:
    the cache is rebuilt when any tensor's data pointer or version counter
    (bumped by in-place writes such as ``load_state_dict``) changes, or the
    dtype does."""

    def __init__(self):
        self._key = None
        self._cast = {}

    def get(self, tensors, dtype):
        """tensors: {name: tensor} -> {name: tensor in ``dtype``}."""
        key = (dtype,) + tuple((k, t.data_ptr(), t._version)
                               for k, t in tensors.items())
        if key != self._key:
            with torch.no_grad():
                self._cast = {k: t.detach().to(dtype)
                              for k, t in tensors.items()}
            self._key = key
        return self._cast


def conv2d(x, weight, bias=None, stride=1, padding=0):
    """2D conv in x.dtype; ``padding`` int means symmetric zero pad (torch
    semantics); the bias is added after the conv."""
    out = F.conv2d(x, weight, None, stride, padding)
    return out if bias is None else out + bias[None, :, None, None]


def conv_transpose2d(x, weight, bias=None, stride=2, padding=1,
                     output_padding=1):
    """torch ConvTranspose2d with an IOHW weight:
    out = (in - 1) * stride - 2 * padding + k + output_padding; the bias is
    added after the conv."""
    out = F.conv_transpose2d(x, weight, None, stride, padding,
                             output_padding)
    return out if bias is None else out + bias[None, :, None, None]


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
    mode is never used for inference. Statistics, scale and bias are
    computed in float32, then cast to x.dtype for ``x * scale + bias``."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    inv = torch.rsqrt(var + eps)
    s = inv * scale[None, :, None, None]
    b = bias[None, :, None, None] - mean * inv * scale[None, :, None, None]
    return x * s.to(x.dtype) + b.to(x.dtype)


def relu(x):
    return torch.relu(x)


def leaky_relu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def tanh(x):
    return torch.tanh(x)
