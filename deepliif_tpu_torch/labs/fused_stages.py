"""Fused translator-stage kernels for inference: the stride-2 down convs and
the up conv-transposes of the ResNet translator, each with the previous
stage's norm affine and ReLU applied to its input and the statistics of
its output for the next norm.

Port of deepliif_tpu/labs/fused_stages.py (``conv3x3_s2_stats``,
``convtranspose3_s2_stats``), the kernels of the JAX package's fused
translator stages (``DEEPLIIF_FUSE_STAGES=1``; here the ``fuse_stages``
option, nets/resnet.py). The JAX package's space-to-depth tail kernel
(``tail_s2d_block`` / ``tail_s2d_fused``) is on no product path there and
is not ported (ROADMAP.md).

``conv3x3_s2_stats`` launches ``csrc/conv3x3_s2_stats.cu`` and
``convtranspose3_s2_stats`` launches ``csrc/convtranspose3_s2_stats.cu``
for a CUDA tensor (bfloat16 only, as the JAX path); a CPU tensor runs the
plain version (``*_reference``, float32 or bfloat16); on any other device,
dtype or layout they raise. There is no fallback from a kernel to its plain
version.

Tensors keep the JAX package's layout: activations NHWC (S, H, W, C),
weights HWIO (3, 3, Cin, Cout) (the conv-transpose's in the forward-conv
layout, spatially flipped: ``utils.checkpoints.weight_to_hwio``), norm
affine (S, Cin), stats (S, 2, Cout) as [sum, sum of squares]. The weight is
cast to x.dtype; the affine runs in x.dtype (scale and bias rounded to it,
the product and the sum each rounded); the conv sums float32 products; y is
rounded to x.dtype and the stats come from the float32 conv output.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops.fused_resblock import _check_affine, _stats, _transform
from ..utils.checkpoints import weight_from_hwio

_LIBS = {'conv3x3_s2_stats': ['conv3x3_s2_stats.cu'],
         'convtranspose3_s2_stats': ['convtranspose3_s2_stats.cu']}


@functools.cache
def _lib(name):
    lib = cuda_build.load(name, _LIBS[name])
    p, i = ctypes.c_void_p, ctypes.c_int
    getattr(lib, f'{name}_num_tiles').argtypes = [i, i]
    getattr(lib, f'{name}_num_tiles').restype = i
    fn = getattr(lib, f'{name}_bf16')
    fn.argtypes = [p] * 7 + [i] * 7 + [p]
    fn.restype = i
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
    if cin % 8 or cout % 8 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f'the {name} kernel needs Cin, Cout % 8 == 0 and '
                         f'16-byte aligned x and w (Cin={cin}, Cout={cout})')
    _check_affine(in_scale, in_bias, s_n, cin, x.device)
    lib = _lib(name)
    ho, wo = out_hw
    y = torch.empty((s_n, ho, wo, cout), dtype=x.dtype, device=x.device)
    n_tiles = getattr(lib, f'{name}_num_tiles')(h, w_n)
    partial = torch.empty((s_n, n_tiles, 2, cout), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((s_n, 2, cout), dtype=torch.float32, device=x.device)
    has_affine = in_scale is not None
    with torch.cuda.device(x.device):
        err = getattr(lib, f'{name}_bf16')(
            x.data_ptr(), w.data_ptr(),
            in_scale.data_ptr() if has_affine else None,
            in_bias.data_ptr() if has_affine else None,
            y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            s_n, h, w_n, cin, cout, int(has_affine), int(bool(in_relu)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: cudaError {err}')
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
    conv3x3_s2_stats.launches += 1
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
    convtranspose3_s2_stats.launches += 1
    return out


convtranspose3_s2_stats.launches = 0
