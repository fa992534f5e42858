"""Fused ResNet-trunk resblock for inference: the CUDA kernel and its plain
PyTorch twin.

Port of deepliif_tpu/ops/fused_resblock.py (``conv3x3_stats``,
``finalize_norm``, ``resblock_chain``). One resblock at inference is

    h1, st1 = conv3x3_stats(x)                       # conv + stats
    h2, st2 = conv3x3_stats(h1, norm1(st1) -> affine, relu)
    x       = x + norm2(st2) applied to h2

so each intermediate activation is written once and read once; the norm
finalize is a tiny (S, C) op between calls. ``conv3x3_stats`` launches the
hand-written kernel in ``csrc/conv3x3_stats.cu`` for a CUDA tensor and runs
``conv3x3_stats_reference`` (torch pad + conv2d + sums) for a CPU tensor;
on any other device, dtype or layout it raises. There is no fallback from
the kernel to the plain version.

Tensors keep the JAX package's layout: activations NHWC (S, H, W, C),
weights HWIO (3, 3, C, C), norm affine (S, C), stats (S, 2, C) as
[sum, sum of squares]. The kernel's int8 twin (``conv3x3_stats_int8``) is
not ported yet (ROADMAP, Queue 2).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

_PADDINGS = ('reflect', 'zero')


@functools.cache
def _lib():
    lib = cuda_build.load('conv3x3_stats', ['conv3x3_stats.cu'])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_stats_num_tiles.argtypes = [i, i]
    lib.conv3x3_stats_num_tiles.restype = i
    lib.conv3x3_stats_f32.argtypes = [p, p, p, p, p, p, p,
                                      i, i, i, i, i, i, i, p]
    lib.conv3x3_stats_f32.restype = i
    return lib


def build():
    """Compile (if needed) and load the kernel library; returns it."""
    return _lib()


def conv3x3_stats_reference(x, w, *, padding='reflect', in_scale=None,
                            in_bias=None, in_relu=False):
    """Plain PyTorch version of ``conv3x3_stats`` (same signature and
    result): affine -> ReLU -> pad -> conv2d, then per-(sample, channel)
    sums of y and y^2 in float32."""
    if padding not in _PADDINGS:
        raise ValueError(f'padding must be one of {_PADDINGS}, got {padding!r}')
    u = x.permute(0, 3, 1, 2)
    if in_scale is not None:
        u = u * in_scale[:, :, None, None] + in_bias[:, :, None, None]
    if in_relu:
        u = torch.relu(u)
    u = F.pad(u, (1, 1, 1, 1), mode='reflect' if padding == 'reflect'
              else 'constant')
    y = F.conv2d(u, w.permute(3, 2, 0, 1))
    y32 = y.float()
    stats = torch.stack([y32.sum((2, 3)), (y32 * y32).sum((2, 3))], dim=1)
    return y.permute(0, 2, 3, 1).contiguous(), stats


def _check(x, w, padding, in_scale, in_bias):
    if padding not in _PADDINGS:
        raise ValueError(f'padding must be one of {_PADDINGS}, got {padding!r}')
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f'conv3x3_stats kernel takes float32, got x {x.dtype}'
                        f', w {w.dtype} (bf16: ROADMAP Queue 1 item 7)')
    if x.dim() != 4:
        raise ValueError(f'x must be (S, H, W, C), got {tuple(x.shape)}')
    s_n, h, w_n, c = x.shape
    if tuple(w.shape) != (3, 3, c, c):
        raise ValueError(f'w must be (3, 3, {c}, {c}) HWIO, got '
                         f'{tuple(w.shape)}')
    if padding == 'reflect' and (h < 2 or w_n < 2):
        raise ValueError(f'reflect padding needs H, W >= 2, got {h}x{w_n}')
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError('conv3x3_stats kernel takes contiguous NHWC x and '
                         'HWIO w')
    if w.device != x.device:
        raise ValueError(f'x on {x.device}, w on {w.device}')
    if (in_scale is None) != (in_bias is None):
        raise ValueError('in_scale and in_bias go together')
    if in_scale is not None:
        for name, t in (('in_scale', in_scale), ('in_bias', in_bias)):
            if (tuple(t.shape) != (s_n, c) or t.dtype != torch.float32
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(f'{name} must be contiguous float32 '
                                 f'({s_n}, {c}) on {x.device}')


def conv3x3_stats(x, w, *, padding='reflect', in_scale=None, in_bias=None,
                  in_relu=False):
    """Fused (affine -> relu ->) conv3x3 (stride 1, 'same' via reflect/zero
    pad) + per-(sample, channel) output statistics.

    x: (S, H, W, C) float32; w: (3, 3, C, C) HWIO; in_scale/in_bias:
    (S, C) or None. Returns (y (S, H, W, C), stats (S, 2, C) float32
    [sum, sum of squares]). A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel on the current stream (and counts it in
    ``conv3x3_stats.launches``) or raises.
    """
    if x.device.type == 'cpu':
        return conv3x3_stats_reference(x, w, padding=padding,
                                       in_scale=in_scale, in_bias=in_bias,
                                       in_relu=in_relu)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3_stats runs on cpu or cuda, got {x.device}')
    _check(x, w, padding, in_scale, in_bias)
    s_n, h, w_n, c = x.shape
    lib = _lib()
    y = torch.empty_like(x)
    n_tiles = lib.conv3x3_stats_num_tiles(h, w_n)
    partial = torch.empty((s_n, n_tiles, 2, c), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((s_n, 2, c), dtype=torch.float32, device=x.device)
    has_affine = in_scale is not None
    with torch.cuda.device(x.device):
        err = lib.conv3x3_stats_f32(
            x.data_ptr(), w.data_ptr(),
            in_scale.data_ptr() if has_affine else None,
            in_bias.data_ptr() if has_affine else None,
            y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            s_n, h, w_n, c, int(padding == 'reflect'), int(has_affine),
            int(bool(in_relu)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'conv3x3_stats kernel launch failed: cudaError {err}')
    conv3x3_stats.launches += 1
    return y, stats


conv3x3_stats.launches = 0


def finalize_norm(st, scale, bias, h, w, eps=1e-5):
    """stats (S, 2, C) -> per-(sample, channel) (scale, bias) of the affine
    batch-stat norm (biased variance E[y^2] - mean^2, clamped at 0)."""
    n = float(h * w)
    mean = st[:, 0] / n
    var = st[:, 1] / n - mean * mean
    inv = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    out_scale = inv * scale[None]
    out_bias = bias[None] - mean * out_scale
    return out_scale.contiguous(), out_bias.contiguous()


def _chain(conv, x, blocks, padding, eps):
    _, h, w_n, _ = x.shape
    for b in blocks:
        h1, st1 = conv(x, b['w1'], padding=padding)
        sc1, bi1 = finalize_norm(st1, b['norm1']['scale'],
                                 b['norm1']['bias'], h, w_n, eps)
        h2, st2 = conv(h1, b['w2'], padding=padding, in_scale=sc1,
                       in_bias=bi1, in_relu=True)
        sc2, bi2 = finalize_norm(st2, b['norm2']['scale'],
                                 b['norm2']['bias'], h, w_n, eps)
        x = x + (h2 * sc2[:, None, None] + bi2[:, None, None])
    return x


def resblock_chain(x, blocks, *, padding='reflect', eps=1e-5):
    """Run a chain of inference resblocks through ``conv3x3_stats``.

    x: (S, H, W, C); blocks: list of dicts {'w1', 'norm1', 'w2', 'norm2'}
    with HWIO (3, 3, C, C) kernels and norm dicts {'scale', 'bias'} of (C,).
    Same semantics as the unfused resnet loop with per-sample batch-stat
    norm, no conv bias and dropout inactive."""
    return _chain(conv3x3_stats, x, blocks, padding, eps)


def resblock_chain_reference(x, blocks, *, padding='reflect', eps=1e-5):
    """``resblock_chain`` through the plain ``conv3x3_stats_reference`` on
    any device."""
    return _chain(conv3x3_stats_reference, x, blocks, padding, eps)
