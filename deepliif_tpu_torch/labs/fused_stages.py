"""Fused translator-stage kernels for inference: the stride-2 down convs and
the up conv-transposes of the ResNet translator, each with the previous
stage's norm affine and ReLU applied to its input and the statistics of
its output for the next norm, and the tail (affine, ReLU, 3-px pad, 7x7
conv, bias, tanh).

Port of deepliif_tpu/labs/fused_stages.py (``conv3x3_s2_stats``,
``convtranspose3_s2_stats``, ``tail_s2d_block`` / ``tail_s2d_fused``), the
kernels of the JAX package's fused translator stages
(``DEEPLIIF_FUSE_STAGES=1``; here the ``fuse_stages`` option,
nets/resnet.py). The JAX fused path ends in XLA's tail conv; the port ends
it with ``tail_s2d_fused``, the same function with the same bf16 rounding
points.

``conv3x3_s2_stats`` launches ``csrc/conv3x3_s2_stats.cu`` and
``convtranspose3_s2_stats`` ``csrc/convtranspose3_s2_stats.cu`` (both the
implicit-GEMM ``wgmma`` kernel of ``csrc/conv3x3_wgmma.cuh``, with its
weights packed per call into a workspace; the conv-transpose in its phase
form) and ``tail_s2d_fused`` / ``tail_s2d_block`` ``csrc/tail_s2d.cu``
for a CUDA tensor (bfloat16 only, as the JAX path); a CPU tensor runs the
plain version (``*_reference``, float32 or bfloat16); on any other device,
dtype or layout they raise. There is no fallback from a kernel to its plain
version.

Tensors keep the JAX package's layout: activations NHWC (S, H, W, C),
weights HWIO (3, 3, Cin, Cout) or (7, 7, Cin, Cout) (the conv-transpose's
in the forward-conv layout, spatially flipped:
``utils.checkpoints.weight_to_hwio``), norm affine (S, Cin), stats (S, 2,
Cout) as [sum, sum of squares]. The weight is cast to x.dtype; the affine
runs in x.dtype (scale and bias rounded to it, the product and the sum
each rounded); the conv sums float32 products; y is rounded to x.dtype and
the stats come from the float32 conv output. The one exception to the
layout is the output of ``tail_s2d_fused``: (S, Cout, H, W), the layout
the generator returns.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops.fused_resblock import (_check_affine, _check_padding, _misaligned,
                                  _stats, _transform)
from ..utils.checkpoints import weight_from_hwio

_LIBS = {'conv3x3_s2_stats': ['conv3x3_s2_stats.cu'],
         'convtranspose3_s2_stats': ['convtranspose3_s2_stats.cu'],
         'tail_s2d': ['tail_s2d.cu']}
TAIL_K, TAIL_COUT = 7, 3      # the kernel's 7x7 conv and its output width


@functools.cache
def _lib(name):
    lib = cuda_build.load(name, _LIBS[name])
    p, i = ctypes.c_void_p, ctypes.c_int
    getattr(lib, f'{name}_num_tiles').argtypes = [i, i]
    getattr(lib, f'{name}_num_tiles').restype = i
    # a kernel that exports <name>_wpack_bytes(Cin, Cout) takes a workspace
    # of that many bytes after w (its weights, packed per call)
    wpack_bytes = getattr(lib, f'{name}_wpack_bytes', None)
    if wpack_bytes is not None:
        wpack_bytes.argtypes = [i, i]
        wpack_bytes.restype = ctypes.c_long
    fn = getattr(lib, f'{name}_bf16')
    fn.argtypes = [p] * (7 + (wpack_bytes is not None)) + [i] * 7 + [p]
    fn.restype = i
    return lib


@functools.cache
def _tail_lib():
    lib = cuda_build.load('tail_s2d', _LIBS['tail_s2d'])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tail_s2d_wpack_bytes.argtypes = [i]
    lib.tail_s2d_wpack_bytes.restype = ctypes.c_long
    lib.tail_s2d_bf16.argtypes = [p] * 7 + [i] * 9 + [p]
    lib.tail_s2d_bf16.restype = i
    return lib


def _plain(conv, kind, x, w, in_scale, in_bias, in_relu):
    """affine -> ReLU in x.dtype, ``conv`` in float32 with the torch kernel
    of the HWIO weight (cast to x.dtype first), y in x.dtype, stats from
    the float32 conv output."""
    u = _transform(x, in_scale, in_bias, in_relu).permute(0, 3, 1, 2)
    y32 = conv(u.float(), weight_from_hwio(w.to(x.dtype).float(), kind))
    return y32.to(x.dtype).permute(0, 2, 3, 1).contiguous(), _stats(y32)


def conv3x3_s2_stats_reference(x, w, *, in_scale=None, in_bias=None,
                               in_relu=False):
    """Plain PyTorch version of ``conv3x3_s2_stats`` (same signature and
    result): a float32 stride-2 conv with zero padding 1, which comes
    after the affine."""
    return _plain(functools.partial(F.conv2d, stride=2, padding=1), 'conv',
                  x, w, in_scale, in_bias, in_relu)


def convtranspose3_s2_stats_reference(x, w, *, in_scale=None, in_bias=None,
                                      in_relu=False):
    """Plain PyTorch version of ``convtranspose3_s2_stats`` (same signature
    and result): a float32 ConvTranspose2d(3, 2, 1, output_padding=1)."""
    return _plain(functools.partial(F.conv_transpose2d, stride=2, padding=1,
                                    output_padding=1), 'convT',
                  x, w, in_scale, in_bias, in_relu)


def _launch(name, x, w, in_scale, in_bias, in_relu, out_hw):
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise TypeError(f'{name} kernel takes contiguous NHWC bfloat16 x, '
                        f'got {x.dtype} {tuple(x.shape)}')
    s_n, h, w_n, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f'w must be (3, 3, {cin}, Cout) HWIO, got '
                         f'{tuple(w.shape)}')
    cout = w.shape[3]
    if w.device != x.device:
        raise ValueError(f'x on {x.device}, w on {w.device}')
    w = w.to(torch.bfloat16).contiguous()
    _check_affine(in_scale, in_bias, s_n, cin, x.device)
    if cin % 8 or cout % 8 or _misaligned(x, w, in_scale, in_bias):
        raise ValueError(f'the {name} kernel needs Cin, Cout % 8 == 0 and '
                         f'16-byte aligned x, w, in_scale and in_bias '
                         f'(Cin={cin}, Cout={cout})')
    lib = _lib(name)
    ho, wo = out_hw
    y = torch.empty((s_n, ho, wo, cout), dtype=x.dtype, device=x.device)
    n_tiles = getattr(lib, f'{name}_num_tiles')(h, w_n)
    partial = torch.empty((s_n, n_tiles, 2, cout), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((s_n, 2, cout), dtype=torch.float32, device=x.device)
    has_affine = in_scale is not None
    wpack_bytes = getattr(lib, f'{name}_wpack_bytes', None)
    workspace = ([] if wpack_bytes is None else
                 [torch.empty(wpack_bytes(cin, cout), dtype=torch.uint8,
                              device=x.device)])
    with torch.cuda.device(x.device):
        err = getattr(lib, f'{name}_bf16')(
            x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in workspace),
            in_scale.data_ptr() if has_affine else None,
            in_bias.data_ptr() if has_affine else None,
            y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            s_n, h, w_n, cin, cout, int(has_affine), int(bool(in_relu)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: cudaError {err} '
                           '(1000 + a CUresult if x\'s TMA tensor map was '
                           'refused)')
    return y, stats


def conv3x3_s2_stats(x, w, *, in_scale=None, in_bias=None, in_relu=False):
    """Fused (affine -> relu ->) 3x3 stride-2 zero-pad-1 conv + output
    stats: torch Conv2d(Cin, Cout, 3, stride=2, padding=1, bias=False).

    x: (S, H, W, Cin), H and W even; w: (3, 3, Cin, Cout) HWIO;
    in_scale/in_bias: (S, Cin) float32 or None. Returns (y (S, H/2, W/2,
    Cout) in x.dtype, stats (S, 2, Cout) float32). A CPU tensor runs the
    plain version; a CUDA tensor (bfloat16, Cin and Cout % 8 == 0) launches
    the kernel on the current stream and counts it in
    ``conv3x3_s2_stats.launches``, or raises."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f'conv3x3_s2_stats needs even H, W, got '
                         f'{tuple(x.shape)}')
    if x.device.type == 'cpu':
        return conv3x3_s2_stats_reference(x, w, in_scale=in_scale,
                                          in_bias=in_bias, in_relu=in_relu)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3_s2_stats runs on cpu or cuda, got '
                         f'{x.device}')
    out = _launch('conv3x3_s2_stats', x, w, in_scale, in_bias, in_relu,
                  (x.shape[1] // 2, x.shape[2] // 2))
    cuda_build.count(conv3x3_s2_stats)
    return out


conv3x3_s2_stats.launches = 0


def convtranspose3_s2_stats(x, w, *, in_scale=None, in_bias=None,
                            in_relu=False):
    """Fused (affine -> relu ->) ConvTranspose2d(3, 2, 1, output_padding=1)
    + output stats.

    x: (S, H, W, Cin); w: (3, 3, Cin, Cout) in the forward-conv HWIO layout
    (the torch IOHW kernel spatially flipped); in_scale/in_bias: (S, Cin)
    float32 or None. Returns (y (S, 2H, 2W, Cout) in x.dtype, stats (S, 2,
    Cout) float32). A CPU tensor runs the plain version; a CUDA tensor
    (bfloat16, Cin and Cout % 8 == 0) launches the kernel on the current
    stream and counts it in ``convtranspose3_s2_stats.launches``, or
    raises."""
    if x.device.type == 'cpu':
        return convtranspose3_s2_stats_reference(
            x, w, in_scale=in_scale, in_bias=in_bias, in_relu=in_relu)
    if x.device.type != 'cuda':
        raise ValueError(f'convtranspose3_s2_stats runs on cpu or cuda, got '
                         f'{x.device}')
    out = _launch('convtranspose3_s2_stats', x, w, in_scale, in_bias,
                  in_relu, (2 * x.shape[1], 2 * x.shape[2]))
    cuda_build.count(convtranspose3_s2_stats)
    return out


convtranspose3_s2_stats.launches = 0


# ---------------------------------------------------------------------------
# tail: (affine -> relu ->) pad 3 -> 7x7 conv (-> + bias -> tanh)
# ---------------------------------------------------------------------------

def _tail_conv(x, w, in_scale, in_bias, in_relu, padding):
    """affine -> ReLU in x.dtype, pad 3 (reflect, or zero after the
    affine), a float32 7x7 conv of the HWIO weight cast to x.dtype:
    (S, Cout, H, W) float32."""
    _check_padding(padding)
    u = _transform(x, in_scale, in_bias, in_relu).permute(0, 3, 1, 2).float()
    u = F.pad(u, (3, 3, 3, 3), mode='reflect' if padding == 'reflect'
              else 'constant')
    return F.conv2d(u, weight_from_hwio(w.to(x.dtype).float(), 'conv'))


def _to_blocks(y):
    """(S, Cout, H, W) -> the JAX block layout (S, H/8, W/8, 64 Cout):
    [s, i, j, (a * 8 + b) * Cout + c] = y[s, c, 8 i + a, 8 j + b]."""
    s_n, c, h, w = y.shape
    return (y.reshape(s_n, c, h // 8, 8, w // 8, 8).permute(0, 2, 4, 3, 5, 1)
            .reshape(s_n, h // 8, w // 8, 64 * c))


def tail_s2d_fused_reference(x, w, b=None, *, in_scale=None, in_bias=None,
                             in_relu=False, padding='reflect'):
    """Plain PyTorch version of ``tail_s2d_fused`` (same signature and
    result): the float32 conv rounded to x.dtype, ``b`` added in x.dtype,
    tanh."""
    y = _tail_conv(x, w, in_scale, in_bias, in_relu, padding).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)[None, :, None, None]
    return torch.tanh(y)


def tail_s2d_block_reference(x, w, *, in_scale=None, in_bias=None,
                             in_relu=False, padding='reflect'):
    """Plain PyTorch version of ``tail_s2d_block`` (same signature and
    result): the float32 conv rounded to x.dtype, in the block layout."""
    return _to_blocks(_tail_conv(x, w, in_scale, in_bias, in_relu,
                                 padding).to(x.dtype))


def _tail_launch(x, w, b, in_scale, in_bias, in_relu, padding, fused):
    _check_padding(padding)
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise TypeError(f'tail_s2d kernel takes contiguous NHWC bfloat16 x, '
                        f'got {x.dtype} {tuple(x.shape)}')
    s_n, h, w_n, cin = x.shape
    if tuple(w.shape) != (TAIL_K, TAIL_K, cin, TAIL_COUT):
        raise ValueError(f'the tail_s2d kernel takes w ({TAIL_K}, {TAIL_K}, '
                         f'{cin}, {TAIL_COUT}) HWIO, got {tuple(w.shape)}')
    if padding == 'reflect' and (h < 4 or w_n < 4):
        raise ValueError(f'reflect padding by 3 needs H, W >= 4, got '
                         f'{h}x{w_n}')
    for name, t in (('w', w), ('b', b)):
        if t is not None and t.device != x.device:
            raise ValueError(f'x on {x.device}, {name} on {t.device}')
    if b is not None and tuple(b.shape) != (TAIL_COUT,):
        raise ValueError(f'b must be ({TAIL_COUT},), got {tuple(b.shape)}')
    w = w.to(torch.bfloat16).contiguous()
    b = None if b is None else b.to(torch.bfloat16).contiguous()
    if cin % 8 or x.data_ptr() % 16:
        raise ValueError(f'the tail_s2d kernel needs Cin % 8 == 0 and a '
                         f'16-byte aligned x (Cin={cin})')
    _check_affine(in_scale, in_bias, s_n, cin, x.device)
    lib = _tail_lib()
    y = torch.empty((s_n, TAIL_COUT, h, w_n), dtype=x.dtype, device=x.device)
    # the weights packed per call into the kernel's K-major image
    wpk = torch.empty(lib.tail_s2d_wpack_bytes(cin), dtype=torch.uint8,
                      device=x.device)
    has_affine = in_scale is not None
    with torch.cuda.device(x.device):
        err = lib.tail_s2d_bf16(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            in_scale.data_ptr() if has_affine else None,
            in_bias.data_ptr() if has_affine else None, y.data_ptr(),
            wpk.data_ptr(), s_n, h, w_n, cin, TAIL_COUT, int(has_affine),
            int(bool(in_relu)), int(padding == 'reflect'), int(fused),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'tail_s2d kernel launch failed: cudaError {err}')
    return y


def tail_s2d_fused(x, w, b=None, *, in_scale=None, in_bias=None,
                   in_relu=False, padding='reflect'):
    """Fused (affine -> relu ->) pad 3 -> 7x7 conv -> + bias -> tanh: the
    translator tail, tanh(conv2d(pad2d(norm_relu(x), 3, padding), w) + b)
    with the conv rounded to x.dtype before the bias.

    x: (S, H, W, Cin); w: (7, 7, Cin, Cout) HWIO; b: (Cout,) or None;
    in_scale/in_bias: (S, Cin) float32 or None; padding 'reflect' or
    'zero' (after the affine). Returns (S, Cout, H, W) in x.dtype. A CPU
    tensor runs the plain version; a CUDA tensor (bfloat16, Cin % 8 == 0,
    Cout == 3) launches the kernel on the current stream and counts it in
    ``tail_s2d_fused.launches``, or raises."""
    if x.device.type == 'cpu':
        return tail_s2d_fused_reference(x, w, b, in_scale=in_scale,
                                        in_bias=in_bias, in_relu=in_relu,
                                        padding=padding)
    if x.device.type != 'cuda':
        raise ValueError(f'tail_s2d_fused runs on cpu or cuda, got '
                         f'{x.device}')
    y = _tail_launch(x, w, b, in_scale, in_bias, in_relu, padding, True)
    cuda_build.count(tail_s2d_fused)
    return y


tail_s2d_fused.launches = 0


def tail_s2d_block(x, w, *, in_scale=None, in_bias=None, in_relu=False,
                   padding='reflect'):
    """The conv part of ``tail_s2d_fused`` in the JAX block layout: (S,
    H/8, W/8, 64 Cout) in x.dtype, no bias or tanh; H and W % 8 == 0. A
    CUDA tensor launches the same kernel with its bias and tanh off and
    counts it in ``tail_s2d_block.launches``."""
    if x.shape[1] % 8 or x.shape[2] % 8:
        raise ValueError(f'tail_s2d_block needs H, W % 8 == 0, got '
                         f'{tuple(x.shape)}')
    if x.device.type == 'cpu':
        return tail_s2d_block_reference(x, w, in_scale=in_scale,
                                        in_bias=in_bias, in_relu=in_relu,
                                        padding=padding)
    if x.device.type != 'cuda':
        raise ValueError(f'tail_s2d_block runs on cpu or cuda, got '
                         f'{x.device}')
    y = _tail_launch(x, w, None, in_scale, in_bias, in_relu, padding, False)
    cuda_build.count(tail_s2d_block)
    return _to_blocks(y)


tail_s2d_block.launches = 0
