"""int8 convolutions of int8 scope 'all': the CUDA kernel and its plain
PyTorch versions.

Port of the int8 route of deepliif_tpu/nets/layers.py ``conv2d``
(:114-124) and ``conv_transpose2d`` (:500-510): the activation arrives
quantized (``ops.quant.quant_act_static`` / ``quant_act_dynamic``), the
int8 x int8 conv accumulates into int32 exactly, then

    out = bf16(f32(acc) * deq)  (+ bias in the output dtype)

with ``deq`` the per-output-channel ``w_s`` (static scales, the activation
scale folded into it) or ``s * w_s`` per sample (dynamic, one float32
product, (N, C_out)). XLA's int8 conv is not a Pallas kernel, but PyTorch
has no int8 convolution on CUDA, so a CUDA tensor launches the hand-written
implicit GEMM ``csrc/conv_s8.cu`` (mma.sync s8, every kind of the
flagship's int8 forward in one kernel; counted in ``conv_s8.launches``),
and a CPU tensor runs the plain version (``*_reference``): the int8 values
through a float64 conv, exact because every partial sum is an integer
below 127^2 * 16 * 1024 < 2^53, then the cast to int32 and the same
epilogue. On CUDA a shape the kernel does not take raises; there is no
fallback to the plain version.

Layouts are the JAX package's: x_q (N, H, W, C_in) int8 NHWC, w_q HWIO
(KH, KW, C_in, C_out) int8 (conv-transposes spatially flipped, the
input-dilated form), outputs (N, H_out, W_out, C_out) NHWC.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

_LIBS = {'conv_s8': ['conv_s8.cu']}
_OUT_DTYPES = (torch.bfloat16, torch.float32)


@functools.cache
def _lib():
    lib = cuda_build.load('conv_s8', _LIBS['conv_s8'])
    p, i = ctypes.c_void_p, ctypes.c_int
    # x, w (packed), deq, bias, y; N, H, W, Cin, HO, WO, Cout, KH, KW,
    # stride, dil, pad_h, pad_w, deq_per_sample, out_f32; the stream
    lib.conv_s8.argtypes = [p] * 5 + [i] * 15 + [p]
    lib.conv_s8.restype = i
    return lib


def _pads(padding):
    """int p, or ((lo, hi), (lo, hi)) -> ((lo, hi), (lo, hi))."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (a, b), (c, d) = padding
    return (int(a), int(b)), (int(c), int(d))


def _transpose_pads(k, padding, output_padding):
    """The input-dilated conv's (lo, hi) of ConvTranspose2d(k, padding,
    output_padding) (the JAX package's conv_transpose2d)."""
    lo = k - 1 - padding
    return lo, lo + output_padding


def _epilogue(acc, deq, bias, out_dtype):
    """acc (N, HO, WO, C) int32 -> f32(acc) * deq rounded to out_dtype, then
    + bias in out_dtype."""
    deq = deq.float()
    d = deq[:, None, None, :] if deq.dim() == 2 else deq
    out = (acc.float() * d).to(out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out.contiguous()


def conv2d_int8_reference(x_q, w_q, deq, bias=None, stride=1, padding=0,
                          out_dtype=torch.bfloat16):
    """Plain PyTorch version of ``conv2d_int8`` (same signature and
    result): pad with zeros, a float64 conv of the int8 values (exact), the
    int32 sums, the epilogue."""
    (hl, hh), (wl, wh) = _pads(padding)
    x = F.pad(x_q.permute(0, 3, 1, 2).double(), (wl, wh, hl, hh))
    acc = F.conv2d(x, w_q.permute(3, 2, 0, 1).double(), stride=stride)
    return _epilogue(acc.to(torch.int32).permute(0, 2, 3, 1), deq, bias,
                     out_dtype)


def conv_transpose2d_int8_reference(x_q, w_q, deq, bias=None, stride=2,
                                    padding=1, output_padding=1,
                                    out_dtype=torch.bfloat16):
    """Plain PyTorch version of ``conv_transpose2d_int8`` (same signature
    and result): the input dilated by ``stride`` (zeros between the
    values), padded by (k - 1 - padding, k - 1 - padding + output_padding),
    a float64 conv with the flipped HWIO kernel (exact), the int32 sums,
    the epilogue."""
    n, h, w, c = x_q.shape
    lo, hi = _transpose_pads(w_q.shape[0], padding, output_padding)
    xd = torch.zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1),
                     dtype=torch.float64, device=x_q.device)
    xd[:, :, ::stride, ::stride] = x_q.permute(0, 3, 1, 2).double()
    xd = F.pad(xd, (lo, hi, lo, hi))
    acc = F.conv2d(xd, w_q.permute(3, 2, 0, 1).double())
    return _epilogue(acc.to(torch.int32).permute(0, 2, 3, 1), deq, bias,
                     out_dtype)


def conv_s8(x_q, w_q, deq, bias, *, stride, dil, pad, out_hw, out_dtype):
    """Launch ``csrc/conv_s8.cu`` on the current stream: the conv of x_q
    (N, H, W, Cin) int8 CUDA, NHWC contiguous, with the HWIO int8 kernel
    w_q at ``stride`` over the input dilated by ``dil`` (one of the two 1),
    zero padding ``pad`` = (top, left) and output size ``out_hw``; the
    epilogue with ``deq`` (Cout,) or (N, Cout) float32 and ``bias`` (Cout,)
    or None. Counts the launch in ``conv_s8.launches``; raises on anything
    the kernel does not take (C_in % 16, C_out % 8, 16-byte alignment) or a
    failed launch."""
    if x_q.device.type != 'cuda':
        raise ValueError(f'conv_s8 launches on cuda, got {x_q.device}')
    if x_q.dtype != torch.int8 or x_q.dim() != 4 or not x_q.is_contiguous():
        raise TypeError(f'conv_s8 takes contiguous NHWC int8 x_q, got '
                        f'{x_q.dtype} {tuple(x_q.shape)}')
    n, h, w, cin = x_q.shape
    kh, kw, wcin, cout = w_q.shape
    if w_q.dtype != torch.int8 or wcin != cin or w_q.device != x_q.device:
        raise ValueError(f'w_q must be int8 (KH, KW, {cin}, C_out) HWIO on '
                         f'{x_q.device}, got {w_q.dtype} {tuple(w_q.shape)} '
                         f'on {w_q.device}')
    if cin % 16 or cout % 8 or x_q.data_ptr() % 16:
        raise ValueError(f'the conv_s8 kernel needs C_in % 16 == 0, C_out % '
                         f'8 == 0 and a 16-byte aligned x_q, got C_in={cin}, '
                         f'C_out={cout}')
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f'conv_s8 writes {_OUT_DTYPES}, got {out_dtype}')
    deq = deq.to(device=x_q.device, dtype=torch.float32).contiguous()
    if tuple(deq.shape) not in ((cout,), (n, cout)):
        raise ValueError(f'deq must be ({cout},) or ({n}, {cout}), got '
                         f'{tuple(deq.shape)}')
    if bias is not None:
        bias = bias.to(device=x_q.device, dtype=out_dtype).contiguous()
        if tuple(bias.shape) != (cout,):
            raise ValueError(f'bias must be ({cout},), got '
                             f'{tuple(bias.shape)}')
    ho, wo = out_hw
    # Cin innermost: the kernel reads 16-byte runs of input channels
    wpk = w_q.permute(0, 1, 3, 2).contiguous()
    y = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=x_q.device)
    with torch.cuda.device(x_q.device):
        err = _lib().conv_s8(
            x_q.data_ptr(), wpk.data_ptr(), deq.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, w, cin, ho, wo, cout, kh, kw, stride, dil, pad[0], pad[1],
            int(deq.dim() == 2), int(out_dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'conv_s8 kernel launch failed: cudaError {err}')
    conv_s8.launches += 1
    return y


conv_s8.launches = 0


def _route(x_q):
    if x_q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'int8 convs run on cpu or cuda, got {x_q.device}')
    return x_q.device.type == 'cpu'


def conv2d_int8(x_q, w_q, deq, bias=None, stride=1, padding=0,
                out_dtype=torch.bfloat16):
    """int8 conv: x_q (N, H, W, C_in) int8 NHWC, w_q (KH, KW, C_in, C_out)
    int8 HWIO, zero ``padding`` (int, or ((top, bottom), (left, right))),
    ``stride``; returns (N, H_out, W_out, C_out) in ``out_dtype``:
    bf16(f32(int32 conv) * deq) + bias. A CPU tensor runs the plain version,
    a CUDA tensor the kernel."""
    if _route(x_q):
        return conv2d_int8_reference(x_q, w_q, deq, bias, stride, padding,
                                     out_dtype)
    (hl, hh), (wl, wh) = _pads(padding)
    _, h, w, _ = x_q.shape
    kh, kw = w_q.shape[:2]
    out_hw = ((h + hl + hh - kh) // stride + 1,
              (w + wl + wh - kw) // stride + 1)
    return conv_s8(x_q, w_q, deq, bias, stride=stride, dil=1, pad=(hl, wl),
                   out_hw=out_hw, out_dtype=out_dtype)


def conv_transpose2d_int8(x_q, w_q, deq, bias=None, stride=2, padding=1,
                          output_padding=1, out_dtype=torch.bfloat16):
    """int8 ConvTranspose2d(k, stride, padding, output_padding) with the
    flipped HWIO kernel w_q (the JAX layout): the conv of the input dilated
    by ``stride``; returns (N, (H - 1) stride - 2 padding + k +
    output_padding, ..., C_out) in ``out_dtype``. The kernel skips the
    dilation's zero taps. A CPU tensor runs the plain version, a CUDA tensor
    the kernel."""
    if _route(x_q):
        return conv_transpose2d_int8_reference(
            x_q, w_q, deq, bias, stride, padding, output_padding, out_dtype)
    _, h, w, _ = x_q.shape
    kh, kw = w_q.shape[:2]
    lo_h, hi_h = _transpose_pads(kh, padding, output_padding)
    lo_w, hi_w = _transpose_pads(kw, padding, output_padding)
    out_hw = ((h - 1) * stride + 1 + lo_h + hi_h - kh + 1,
              (w - 1) * stride + 1 + lo_w + hi_w - kw + 1)
    return conv_s8(x_q, w_q, deq, bias, stride=1, dil=stride,
                   pad=(lo_h, lo_w), out_hw=out_hw, out_dtype=out_dtype)
