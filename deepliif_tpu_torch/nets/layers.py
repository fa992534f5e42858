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

Batch invariance (a tile's outputs do not depend on the batch it rides
in, the JAX package's contract): on CUDA the norm statistics go through the
fixed-order kernel ``csrc/plane_stats.cu`` (``plane_sums``; torch's CUDA
mean splits its sum by the shape of the whole tensor), and the engine gives
every forward one batch shape (``models.InferenceSession.batch_size``), so
cuDNN, which picks its algorithm by the shape of the call, keeps one. On
the CPU every conv and conv-transpose runs one sample at a time
(``_per_sample``): oneDNN also picks by shape.

``conv2d_s2d`` and ``conv_transpose2d_s2d`` of the JAX package are TPU
lowering tricks for a tiny output-channel count; their counterpart here is
the plain conv.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops import cuda_build

_LIBS = {'plane_stats': ['plane_stats.cu']}


class CastCache:
    """Tensors of a net in a compute dtype, cast once per weight version:
    the cache is rebuilt when any tensor's data pointer or version counter
    (bumped by in-place writes such as ``load_state_dict``) changes, or the
    dtype does."""

    def __init__(self):
        self._key = None
        self._cast = {}

    def get(self, tensors, dtype, layout=None):
        """tensors: {name: tensor} -> {name: contiguous tensor in
        ``dtype``}; ``layout(name, tensor)``, if given, re-lays each tensor
        out before the cast."""
        key = (dtype,) + tuple((k, t.data_ptr(), t._version)
                               for k, t in tensors.items())
        if key != self._key:
            with torch.no_grad():
                self._cast = {
                    k: (layout(k, t) if layout else t).detach().to(dtype)
                    .contiguous() for k, t in tensors.items()}
            self._key = key
        return self._cast


def _per_sample(fn, x, *args):
    """``fn(x, *args)``, on the CPU one sample at a time: every oneDNN
    call then has the shape of one tile, so a tile's result does not
    depend on the batch (oneDNN picks its algorithm by the shape of the
    whole call). On CUDA one call: the engine keeps the batch shape fixed
    instead, which costs nothing at batch 16 where cuDNN at batch 1 is
    up to 5x slower."""
    if x.device.type != 'cpu' or x.shape[0] == 1:
        return fn(x, *args)
    return torch.cat([fn(x[i:i + 1], *args) for i in range(x.shape[0])])


def conv2d(x, weight, bias=None, stride=1, padding=0):
    """2D conv in x.dtype; ``padding`` int means symmetric zero pad (torch
    semantics); the bias is added after the conv."""
    out = _per_sample(F.conv2d, x, weight, None, stride, padding)
    return out if bias is None else out + bias[None, :, None, None]


def conv_transpose2d(x, weight, bias=None, stride=2, padding=1,
                     output_padding=1):
    """torch ConvTranspose2d with an IOHW weight:
    out = (in - 1) * stride - 2 * padding + k + output_padding; the bias is
    added after the conv."""
    out = _per_sample(F.conv_transpose2d, x, weight, None, stride, padding,
                      output_padding)
    return out if bias is None else out + bias[None, :, None, None]


def pad2d(x, n, mode='zero'):
    if mode == 'zero':
        return F.pad(x, (n, n, n, n))
    if mode == 'reflect':
        return F.pad(x, (n, n, n, n), mode='reflect')
    raise NotImplementedError(f'padding [{mode}] not ported')


@functools.cache
def _lib():
    lib = cuda_build.load('plane_stats', _LIBS['plane_stats'])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.plane_stats_num_chunks.argtypes = [i]
    lib.plane_stats_num_chunks.restype = i
    for fn in (lib.plane_stats_f32, lib.plane_stats_bf16):
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
    return lib


def plane_sums_reference(x, center=None):
    """Plain PyTorch version of ``plane_sums`` (same signature and
    result)."""
    d = x.float()
    if center is not None:
        d = d - center[:, :, None, None]
    return torch.stack([d.sum(dim=(2, 3)), (d * d).sum(dim=(2, 3))], dim=1)


def plane_sums(x, center=None):
    """Per-(sample, channel) sums over the spatial plane, in float32:
    (S, 2, C) [sum of d, sum of d^2] with d = x - center (center (S, C)
    float32, or 0). x: (S, C, H, W) float32 or bfloat16 in any memory
    layout (NHWC memory, channels_last, is read in place). A CPU tensor
    runs the plain version; a CUDA tensor launches the fixed-order kernel
    (``csrc/plane_stats.cu``: its sums do not depend on the batch) on the
    current stream and counts it in ``plane_sums.launches``, or raises."""
    if x.device.type == 'cpu':
        return plane_sums_reference(x, center)
    if x.device.type != 'cuda':
        raise ValueError(f'plane_sums runs on cpu or cuda, got {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise TypeError(f'plane_sums takes (S, C, H, W) float32 or bfloat16, '
                        f'got {x.dtype} {tuple(x.shape)}')
    s_n, c, h, w = x.shape
    xn = x.permute(0, 2, 3, 1).contiguous()
    on_x = dict(dtype=torch.float32, device=x.device)
    if center is not None:
        if tuple(center.shape) != (s_n, c) or center.device != x.device:
            raise ValueError(f'center must be ({s_n}, {c}) on {x.device}')
        center = center.to(torch.float32).contiguous()
    lib = _lib()
    partial = torch.empty((s_n, lib.plane_stats_num_chunks(h * w), 2, c),
                          **on_x)
    stats = torch.empty((s_n, 2, c), **on_x)
    fn = lib.plane_stats_bf16 if x.dtype == torch.bfloat16 else \
        lib.plane_stats_f32
    with torch.cuda.device(x.device):
        err = fn(xn.data_ptr(), None if center is None else center.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), s_n, h * w, c,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'plane_stats kernel launch failed: cudaError {err}')
    plane_sums.launches += 1
    return stats


plane_sums.launches = 0


def batch_stat_norm(x, scale, bias, eps=1e-5):
    """BatchNorm2d with batch statistics (biased variance), affine, with the
    statistics taken per sample (over H, W): the reference inference
    semantics, where every tile is a batch of one with running stats
    disabled (deepliif_tpu ``batch_stat_norm(per_sample=True)``). Tiles of a
    batch must not couple through the norm, so ``nn.BatchNorm2d`` in train
    mode is never used for inference. Statistics (two passes: the mean,
    then the mean of (x - mean)^2, through ``plane_sums``), scale and bias
    are computed in float32, then cast to x.dtype for ``x * scale +
    bias``."""
    n = x.shape[2] * x.shape[3]
    mean = plane_sums(x)[:, 0] / n
    var = plane_sums(x, mean)[:, 1] / n
    inv = torch.rsqrt(var + eps)[:, :, None, None]
    mean = mean[:, :, None, None]
    s = inv * scale[None, :, None, None]
    b = bias[None, :, None, None] - mean * inv * scale[None, :, None, None]
    return x * s.to(x.dtype) + b.to(x.dtype)


def relu(x):
    return torch.relu(x)


def leaky_relu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def tanh(x):
    return torch.tanh(x)
