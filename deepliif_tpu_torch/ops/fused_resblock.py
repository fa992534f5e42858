"""Fused ResNet-trunk resblock for inference: the CUDA kernels and their
plain PyTorch twins, in float32, bfloat16 and int8.

Port of deepliif_tpu/ops/fused_resblock.py (``conv3x3_stats``,
``conv3x3_stats_int8``, ``finalize_norm``, ``resblock_chain``,
``resblock_chain_int8``). One resblock at inference is

    h1, st1 = conv3x3_stats(x)                       # conv + stats
    h2, st2 = conv3x3_stats(h1, norm1(st1) -> affine, relu)
    x       = x + norm2(st2) applied to h2

so each intermediate activation is written once and read once; the norm
finalize is a tiny (S, C) op between calls. For a CUDA tensor
``conv3x3_stats`` launches the hand-written kernel in
``csrc/conv3x3_stats.cu`` and ``conv3x3_stats_int8`` the one in
``csrc/conv3x3_stats_int8.cu``: all three run the implicit-GEMM ``wgmma``
mainloop of ``csrc/conv3x3_wgmma.cuh`` on the tensor cores (bfloat16;
float32 by split TF32, three TF32 products per multiply-add, as accurate as
a float32 conv; int8 on s8 operands, after a pass that quantizes the input
into per-chunk blocks), with their weights packed per call into a
workspace. A CPU tensor runs the plain version (``*_reference``); on any
other device, dtype, layout or channel count (C % 8) they raise. There is
no fallback from a kernel to its plain version.

Tensors keep the JAX package's layout: activations NHWC (S, H, W, C),
weights HWIO (3, 3, C, C), norm affine (S, C), stats (S, 2, C) as
[sum, sum of squares]. bfloat16 follows the TPU kernel's rounding points:
the norm affine runs in bf16 (scale and bias rounded to bf16, the product
and the sum each rounded), the conv accumulates in float32, y is rounded to
bf16 and the stats come from the float32 accumulator.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

_PADDINGS = ('reflect', 'zero')
_LIBS = {'conv3x3_stats': ['conv3x3_stats.cu'],
         'conv3x3_stats_int8': ['conv3x3_stats_int8.cu']}
# rows per dynamic int8 scale: the JAX package's bf16 chunk
# (deepliif_tpu/ops/fused_resblock.py _resolve_chunk); all of H when H < 16
CHUNK_ROWS = 16


@functools.cache
def _lib():
    lib = cuda_build.load('conv3x3_stats', _LIBS['conv3x3_stats'])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_stats_num_tiles.argtypes = [i, i]
    lib.conv3x3_stats_num_tiles.restype = i
    for fn in (lib.conv3x3_stats_f32_wpack_bytes,
               lib.conv3x3_stats_bf16_wpack_bytes):
        fn.argtypes = [i]
        fn.restype = ctypes.c_long
    # x, w, the packed-weight workspace, in_scale, in_bias, y, partial,
    # stats; S, H, W, C, reflect, has_affine, in_relu; the stream
    for fn in (lib.conv3x3_stats_f32, lib.conv3x3_stats_bf16):
        fn.argtypes = [p] * 8 + [i] * 7 + [p]
        fn.restype = i
    return lib


@functools.cache
def _lib_int8():
    lib = cuda_build.load('conv3x3_stats_int8', _LIBS['conv3x3_stats_int8'])
    p, i, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.conv3x3_stats_int8_num_tiles.argtypes = [i, i]
    lib.conv3x3_stats_int8_num_tiles.restype = i
    lib.conv3x3_stats_int8_wpack_bytes.argtypes = [i]
    lib.conv3x3_stats_int8_wpack_bytes.restype = l_
    lib.conv3x3_stats_int8_qblock_bytes.argtypes = [i] * 5
    lib.conv3x3_stats_int8_qblock_bytes.restype = l_
    # x, w_q, wpack, qblocks, deq, inv_a, in_scale, in_bias, y, m_raw,
    # rowmax, partial, stats; S, H, W, C, ch, reflect, has_affine, in_relu,
    # dynamic; the stream
    lib.conv3x3_stats_int8.argtypes = [p] * 13 + [i] * 9 + [p]
    lib.conv3x3_stats_int8.restype = i
    return lib


def build():
    """Compile (if needed, one nvcc per library, in parallel) and load both
    kernel libraries; returns (float32/bfloat16 library, int8 library)."""
    cuda_build.build(_LIBS)
    return _lib(), _lib_int8()


def _check_padding(padding):
    if padding not in _PADDINGS:
        raise ValueError(f'padding must be one of {_PADDINGS}, got {padding!r}')


def _chunk_rows(h):
    ch = min(CHUNK_ROWS, h)
    if h % ch:
        raise ValueError(f'int8 conv needs H % {CHUNK_ROWS} == 0 or H < '
                         f'{CHUNK_ROWS} (the dynamic-scale chunk), got H={h}')
    return ch


def _transform(x, in_scale, in_bias, in_relu):
    """NHWC relu(x * scale + bias) in x.dtype: scale and bias are cast to
    x.dtype and the product and the sum are each rounded to it."""
    u = x
    if in_scale is not None:
        u = (u * in_scale.to(x.dtype)[:, None, None, :]
             + in_bias.to(x.dtype)[:, None, None, :])
    if in_relu:
        u = torch.relu(u)
    return u


def _stats(y32):
    """(S, C, H, W) float32 -> (S, 2, C) [sum, sum of squares]."""
    return torch.stack([y32.sum((2, 3)), (y32 * y32).sum((2, 3))], dim=1)


def conv3x3_stats_reference(x, w, *, padding='reflect', in_scale=None,
                            in_bias=None, in_relu=False):
    """Plain PyTorch version of ``conv3x3_stats`` (same signature and
    result): affine -> ReLU in x.dtype, pad, a float32 conv2d of those
    values (products of bf16 values are exact in float32), y in x.dtype,
    stats from the float32 conv output."""
    _check_padding(padding)
    u = _transform(x, in_scale, in_bias, in_relu).permute(0, 3, 1, 2)
    u = F.pad(u, (1, 1, 1, 1), mode='reflect' if padding == 'reflect'
              else 'constant')
    y32 = F.conv2d(u.float(), w.float().permute(3, 2, 0, 1))
    return y32.to(x.dtype).permute(0, 2, 3, 1).contiguous(), _stats(y32)


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, the 13
    low bits of the float32 pattern dropped), ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds; returned as float32. Past the largest TF32
    value it rounds to infinity; NaN stays NaN."""
    bits = x.float().contiguous().view(torch.int32)
    # adding half of the dropped unit to the magnitude bits carries into the
    # kept ones exactly when the dropped part is >= half of it (the sign bit
    # stays: a float32 magnitude below NaN's never carries into it)
    out = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x.float(), out)


def conv3x3_stats_split_tf32_reference(x, w, *, padding='reflect',
                                       in_scale=None, in_bias=None,
                                       in_relu=False, products=3):
    """Plain version of the float32 kernel's split-TF32 arithmetic (same
    signature and result as ``conv3x3_stats_reference``, float32 only): u
    (after the affine and ReLU) and w are split as v = hi + lo, hi =
    tf32(v), lo = tf32(v - hi), and y is the float32 sum of the convs of hi
    and hi, hi and lo, lo and hi (each product of two TF32 values is exact
    in float32). ``products=1`` keeps hi and hi alone: what a TF32 conv
    computes."""
    _check_padding(padding)
    u = _transform(x.float(), in_scale, in_bias, in_relu).permute(0, 3, 1, 2)
    u = F.pad(u, (1, 1, 1, 1), mode='reflect' if padding == 'reflect'
              else 'constant')
    wt = w.float().permute(3, 2, 0, 1)
    u_hi, w_hi = tf32_round(u), tf32_round(wt)
    y32 = F.conv2d(u_hi, w_hi)
    if products == 3:
        y32 = (y32 + F.conv2d(u_hi, tf32_round(wt - w_hi))
               + F.conv2d(tf32_round(u - u_hi), w_hi))
    return y32.permute(0, 2, 3, 1).contiguous(), _stats(y32)


def _check_affine(in_scale, in_bias, s_n, c, device):
    if (in_scale is None) != (in_bias is None):
        raise ValueError('in_scale and in_bias go together')
    if in_scale is not None:
        for name, t in (('in_scale', in_scale), ('in_bias', in_bias)):
            if (tuple(t.shape) != (s_n, c) or t.dtype != torch.float32
                    or t.device != device or not t.is_contiguous()):
                raise ValueError(f'{name} must be contiguous float32 '
                                 f'({s_n}, {c}) on {device}')


def _misaligned(*tensors):
    """Whether any of ``tensors`` (None skipped) does not start 16-byte
    aligned (the kernels' 16-byte copies and TMA loads)."""
    return any(t is not None and t.data_ptr() % 16 for t in tensors)


def _check(x, w, padding, in_scale, in_bias):
    _check_padding(padding)
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f'conv3x3_stats kernel takes float32 or bfloat16 x '
                        f'and w of the same dtype, got x {x.dtype}, w '
                        f'{w.dtype}')
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
    _check_affine(in_scale, in_bias, s_n, c, x.device)
    if c % 8 or _misaligned(x, w, in_scale, in_bias):
        kind = 'bfloat16' if x.dtype == torch.bfloat16 else 'float32'
        raise ValueError(f'the {kind} kernel needs C % 8 == 0 and 16-byte '
                         f'aligned x, w, in_scale and in_bias (C={c})')


def conv3x3_stats(x, w, *, padding='reflect', in_scale=None, in_bias=None,
                  in_relu=False):
    """Fused (affine -> relu ->) conv3x3 (stride 1, 'same' via reflect/zero
    pad) + per-(sample, channel) output statistics.

    x: (S, H, W, C) float32 or bfloat16 (C % 8 == 0 on CUDA); w: (3, 3, C,
    C) HWIO of the same dtype; in_scale/in_bias: (S, C) float32 or None.
    Returns (y (S, H, W, C) in x.dtype, stats (S, 2, C) float32 [sum, sum
    of squares]). A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel on the
    current stream (and counts it in ``conv3x3_stats.launches`` for float32,
    ``conv3x3_stats.launches_bf16`` for bfloat16) or raises.
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
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    fn = lib.conv3x3_stats_bf16 if bf16 else lib.conv3x3_stats_f32
    wpack = torch.empty((lib.conv3x3_stats_bf16_wpack_bytes if bf16 else
                         lib.conv3x3_stats_f32_wpack_bytes)(c),
                        dtype=torch.uint8, device=x.device)
    n_tiles = lib.conv3x3_stats_num_tiles(h, w_n)
    partial = torch.empty((s_n, n_tiles, 2, c), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((s_n, 2, c), dtype=torch.float32, device=x.device)
    has_affine = in_scale is not None
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), wpack.data_ptr(),
                 in_scale.data_ptr() if has_affine else None,
                 in_bias.data_ptr() if has_affine else None,
                 y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
                 s_n, h, w_n, c, int(padding == 'reflect'), int(has_affine),
                 int(bool(in_relu)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'conv3x3_stats kernel launch failed: cudaError '
                           f'{err} (1000 + a CUresult if x\'s TMA tensor map '
                           'was refused)')
    if bf16:
        conv3x3_stats.launches_bf16 += 1
    else:
        conv3x3_stats.launches += 1
    return y, stats


conv3x3_stats.launches = 0
conv3x3_stats.launches_bf16 = 0


def conv3x3_stats_int8_reference(x, w_q, deq, inv_a=None, *,
                                 padding='reflect', in_scale=None,
                                 in_bias=None, in_relu=False, dynamic=False):
    """Plain PyTorch version of ``conv3x3_stats_int8`` (same signature and
    result). Quantizes each (sample, chunk) window (the chunk's rows plus
    its two halo rows) as the kernel does (v = u * bf16(1/a) is the exact
    float32 product of two bf16 values, as the JAX kernel computes it under
    XLA), convolves the integer values in
    float64 (exact: every partial sum is an integer far below 2**53, so it
    equals the int32 accumulation), then dequantizes in float32."""
    _check_padding(padding)
    s_n, h, w_n, c = x.shape
    ch = _chunk_rows(h)
    n_ch = h // ch
    u = _transform(x, in_scale, in_bias, in_relu)
    if padding == 'reflect':
        up = torch.cat([u[:, 1:2], u, u[:, h - 2:h - 1]], dim=1)
    else:
        zero = torch.zeros_like(u[:, :1])
        up = torch.cat([zero, u, zero], dim=1)
    rows = (torch.arange(n_ch, device=x.device)[:, None] * ch
            + torch.arange(ch + 2, device=x.device)[None])
    win = up[:, rows]                                # (S, n_ch, ch+2, W, C)
    deq = torch.as_tensor(deq, dtype=torch.float32, device=x.device)
    if dynamic:
        m = win.float().abs().amax(dim=(2, 3, 4)).clamp_min(1e-12)
        # true divisions: on CUDA, tensor / python scalar multiplies by the
        # reciprocal, which rounds differently from the kernel's division
        c127 = torch.full_like(m, 127.0)
        v = win.float() * (c127 / m).to(x.dtype).float()[:, :, None, None, None]
        deq = deq * (m / c127)[:, :, None]          # (S, n_ch, C)
    else:
        inv = torch.as_tensor(inv_a, dtype=torch.float32, device=x.device)
        v = win.float() * inv.reshape(-1).to(x.dtype).float()
    q = torch.clamp(torch.round(v), -127, 127)
    q = q.reshape(s_n * n_ch, ch + 2, w_n, c).permute(0, 3, 1, 2)
    q = F.pad(q, (1, 1, 0, 0), mode='reflect' if padding == 'reflect'
              else 'constant')
    acc = F.conv2d(q.double(), w_q.double().permute(3, 2, 0, 1))
    acc = acc.float().reshape(s_n, n_ch, c, ch, w_n)
    yf = acc * deq.expand(s_n, n_ch, c)[..., None, None]
    yf = yf.permute(0, 2, 1, 3, 4).reshape(s_n, c, h, w_n)
    return yf.to(x.dtype).permute(0, 2, 3, 1).contiguous(), _stats(yf)


def quantize_blocks_int8_reference(x, inv_a=None, *, padding='reflect',
                                   in_scale=None, in_bias=None,
                                   in_relu=False, dynamic=False):
    """Plain version of the int8 kernel's quantize pass: the conv's input
    as per-chunk blocks (S, n_chunks, ch + 2, W + 2, C) int8, each chunk's
    rows with its two halo rows and the halo columns (reflected, or zero),
    quantized at the chunk's scale; and the chunks' scales m (S, n_chunks)
    float32 (max |u| of the window, at least 1e-12; None when static). A
    valid 3x3 integer conv of a block gives the chunk's int32 sums."""
    _check_padding(padding)
    s_n, h, w_n, c = x.shape
    ch = _chunk_rows(h)
    n_ch = h // ch
    u = _transform(x, in_scale, in_bias, in_relu).permute(0, 3, 1, 2)
    u = F.pad(u.float(), (1, 1, 1, 1), mode='reflect' if padding == 'reflect'
              else 'constant').permute(0, 2, 3, 1)   # (S, H + 2, W + 2, C)
    blocks = torch.stack([u[:, r * ch:r * ch + ch + 2]
                          for r in range(n_ch)], dim=1)
    m = None
    if dynamic:
        m = blocks.abs().amax(dim=(2, 3, 4)).clamp_min(1e-12)
        inv = (torch.full_like(m, 127.0) / m).to(x.dtype).float()
        v = blocks * inv[:, :, None, None, None]
    else:
        inv = torch.as_tensor(inv_a, dtype=torch.float32, device=x.device)
        v = blocks * inv.reshape(-1).to(x.dtype).float()
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8), m


def conv3x3_stats_int8(x, w_q, deq, inv_a=None, *, padding='reflect',
                       in_scale=None, in_bias=None, in_relu=False,
                       dynamic=False):
    """Fused (affine -> relu ->) quantize -> int8 conv3x3 -> dequant +
    per-(sample, channel) output statistics.

    x: (S, H, W, C) bfloat16 (C % 8 == 0, H % 16 == 0 or H < 16); w_q:
    (3, 3, C, C) int8 HWIO; deq: (C,) float32 per-output-channel dequant
    scale; inv_a: scalar or (C,) float32 activation quantize scale (1/a_s),
    unused when ``dynamic``. Returns (y (S, H, W, C) bfloat16, stats
    (S, 2, C) float32) with y = conv3x3(clip(rint(u * inv_a)), w_q) * deq
    over the transformed input u. ``dynamic=True``: each (sample, 16-row
    chunk) quantizes by its own max |u| (halo rows included) and
    dequantizes by deq * max/127. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (and counts it in
    ``conv3x3_stats_int8.launches``) or raises.
    """
    if x.device.type == 'cpu':
        return conv3x3_stats_int8_reference(
            x, w_q, deq, inv_a, padding=padding, in_scale=in_scale,
            in_bias=in_bias, in_relu=in_relu, dynamic=dynamic)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3_stats_int8 runs on cpu or cuda, got '
                         f'{x.device}')
    _check_padding(padding)
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise TypeError(f'conv3x3_stats_int8 kernel takes contiguous NHWC '
                        f'bfloat16 x, got {x.dtype} {tuple(x.shape)}')
    s_n, h, w_n, c = x.shape
    if c % 8 or x.data_ptr() % 16:
        raise ValueError(f'the int8 kernel needs C % 8 == 0 and a 16-byte '
                         f'aligned x (C={c})')
    if padding == 'reflect' and (h < 2 or w_n < 2):
        raise ValueError(f'reflect padding needs H, W >= 2, got {h}x{w_n}')
    if w_q.dtype != torch.int8 or tuple(w_q.shape) != (3, 3, c, c):
        raise ValueError(f'w_q must be int8 (3, 3, {c}, {c}) HWIO, got '
                         f'{w_q.dtype} {tuple(w_q.shape)}')
    _check_affine(in_scale, in_bias, s_n, c, x.device)
    ch = _chunk_rows(h)
    on_x = dict(dtype=torch.float32, device=x.device)
    deq = torch.as_tensor(deq, **on_x).reshape(-1).expand(c).contiguous()
    if not dynamic:
        inv_a = torch.as_tensor(inv_a, **on_x).reshape(-1).expand(c).contiguous()
    lib = _lib_int8()
    y = torch.empty_like(x)
    n_tiles = lib.conv3x3_stats_int8_num_tiles(h, w_n)
    wpack = torch.empty(lib.conv3x3_stats_int8_wpack_bytes(c),
                        dtype=torch.uint8, device=x.device)
    qblocks = torch.empty(lib.conv3x3_stats_int8_qblock_bytes(s_n, h, w_n, c,
                                                              ch),
                          dtype=torch.uint8, device=x.device)
    partial = torch.empty((s_n, n_tiles, 2, c), **on_x)
    stats = torch.empty((s_n, 2, c), **on_x)
    m_raw = torch.empty((s_n, h // ch), **on_x)
    rowmax = torch.empty((s_n, h), **on_x)
    w_q = w_q.to(x.device).contiguous()
    # the quantize passes load the per-channel scales as 16-byte vectors
    in_scale, in_bias, inv_a = (t.clone() if _misaligned(t) else t
                                for t in (in_scale, in_bias, inv_a))
    has_affine = in_scale is not None
    with torch.cuda.device(x.device):
        err = lib.conv3x3_stats_int8(
            x.data_ptr(), w_q.data_ptr(), wpack.data_ptr(),
            qblocks.data_ptr(), deq.data_ptr(),
            None if dynamic else inv_a.data_ptr(),
            in_scale.data_ptr() if has_affine else None,
            in_bias.data_ptr() if has_affine else None,
            y.data_ptr(), m_raw.data_ptr(), rowmax.data_ptr(),
            partial.data_ptr(), stats.data_ptr(), s_n, h, w_n, c, ch,
            int(padding == 'reflect'),
            int(has_affine), int(bool(in_relu)), int(bool(dynamic)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'conv3x3_stats_int8 kernel launch failed: '
                           f'cudaError {err} (1000 + a CUresult if the '
                           'quantized blocks\' TMA tensor map was refused)')
    conv3x3_stats_int8.launches += 1
    return y, stats


conv3x3_stats_int8.launches = 0


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


def _chain(conv, x, blocks, eps):
    """The resblock loop around ``conv(x, block, j, **affine)`` (j = 1, 2);
    the residual add runs in x.dtype."""
    _, h, w_n, _ = x.shape
    for b in blocks:
        h1, st1 = conv(x, b, 1)
        sc1, bi1 = finalize_norm(st1, b['norm1']['scale'],
                                 b['norm1']['bias'], h, w_n, eps)
        h2, st2 = conv(h1, b, 2, in_scale=sc1, in_bias=bi1, in_relu=True)
        sc2, bi2 = finalize_norm(st2, b['norm2']['scale'],
                                 b['norm2']['bias'], h, w_n, eps)
        x = x + (h2 * sc2.to(h2.dtype)[:, None, None]
                 + bi2.to(h2.dtype)[:, None, None])
    return x


def resblock_chain(x, blocks, *, padding='reflect', eps=1e-5):
    """Run a chain of inference resblocks through ``conv3x3_stats``.

    x: (S, H, W, C) float32 or bfloat16; blocks: list of dicts {'w1',
    'norm1', 'w2', 'norm2'} with HWIO (3, 3, C, C) kernels in x.dtype and
    norm dicts {'scale', 'bias'} of (C,) float32. Same semantics as the
    unfused resnet loop with per-sample batch-stat norm, no conv bias and
    dropout inactive."""
    return _chain(lambda h, b, j, **kw: conv3x3_stats(
        h, b[f'w{j}'], padding=padding, **kw), x, blocks, eps)


def resblock_chain_reference(x, blocks, *, padding='reflect', eps=1e-5):
    """``resblock_chain`` through the plain ``conv3x3_stats_reference`` on
    any device."""
    return _chain(lambda h, b, j, **kw: conv3x3_stats_reference(
        h, b[f'w{j}'], padding=padding, **kw), x, blocks, eps)


def _int8_conv(conv, padding, dynamic):
    def run(h, b, j, **kw):
        inv_a = None if dynamic else 1.0 / torch.as_tensor(
            b[f'a{j}'], dtype=torch.float32, device=h.device)
        return conv(h, b[f'w{j}q'], b[f'w{j}s'], inv_a, padding=padding,
                    dynamic=dynamic, **kw)
    return run


def resblock_chain_int8(x, blocks, *, padding='reflect', eps=1e-5,
                        dynamic=False):
    """``resblock_chain`` through ``conv3x3_stats_int8``.

    blocks: list of dicts {'w1q', 'w1s', 'a1', 'norm1', 'w2q', 'w2s', 'a2',
    'norm2'}: w*q HWIO (3, 3, C, C) int8, w*s (C,) float32 per-output-
    channel dequant scales, a* the activation scales (scalar or (C,)).
    ``dynamic=False``: w*s is the complete dequant (activation scales
    folded into the weights, ``ops.quant.quantize_conv_int8_static``) and
    the activations quantize by 1/a*. ``dynamic=True``: w*q/w*s are the
    plain per-output-channel quantization, a* are ignored and each (sample,
    16-row chunk) quantizes by its own max |u|."""
    return _chain(_int8_conv(conv3x3_stats_int8, padding, dynamic), x,
                  blocks, eps)


def resblock_chain_int8_reference(x, blocks, *, padding='reflect', eps=1e-5,
                                  dynamic=False):
    """``resblock_chain_int8`` through the plain
    ``conv3x3_stats_int8_reference`` on any device."""
    return _chain(_int8_conv(conv3x3_stats_int8_reference, padding, dynamic),
                  x, blocks, eps)
