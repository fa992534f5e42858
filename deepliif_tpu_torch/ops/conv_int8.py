"""int8 convolutions of int8 scope 'all': the CUDA kernel and its plain
PyTorch versions.

Port of the int8 route of deepliif_tpu/nets/layers.py ``conv2d``
(:114-124) and ``conv_transpose2d`` (:500-510): the activation quantized
(``ops.quant.quant_act_static`` / ``quant_act_dynamic``: static scale, or
per sample), the int8 x int8 conv accumulated into int32 exactly, then

    out = bf16(f32(acc) * deq)  (+ bias in the output dtype)

with ``deq`` the per-output-channel ``w_s`` (static scales, the activation
scale folded into it) or ``s * w_s`` per sample (dynamic, one float32
product, (N, C_out)). XLA's int8 conv is not a Pallas kernel, but PyTorch
has no int8 convolution on CUDA, so a CUDA tensor launches the hand-written
implicit GEMM ``csrc/conv_s8.cu``, which takes the bf16 activation and
quantizes it while loading it (no int8 activation tensor; counted in
``conv_s8.launches``; the dynamic scales' max pass in
``sample_absmax.launches``), and a CPU tensor runs the plain version
(``*_reference``): torch's quantize, the int8 values through a float64
conv, exact because every partial sum is an integer below 127^2 * 16 * 1024
< 2^53, then the cast to int32 and the same epilogue. On CUDA a shape the
kernel does not take raises; there is no fallback to the plain version.

Layouts are the JAX package's: x (N, H, W, C_in) NHWC, w_q HWIO (KH, KW,
C_in, C_out) int8 (conv-transposes spatially flipped, the input-dilated
form), outputs (N, H_out, W_out, C_out) NHWC.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build, quant

_LIBS = {'conv_s8': ['conv_s8.cu']}


@functools.cache
def _lib():
    lib = cuda_build.load('conv_s8', _LIBS['conv_s8'])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # N, H, W, Cin, HO, WO, Cout, KH, KW, stride, dil, pad_h, pad_w
    lib.conv_s8_split.argtypes = [i] * 13
    lib.conv_s8_split.restype = i
    # x, amax; N, elements per sample; the stream
    lib.conv_s8_absmax.argtypes = [p, p, i, ll, p]
    lib.conv_s8_absmax.restype = i
    # x, w_pk, w_s, inv, amax, bias, y, ws; N, H, W, Cin, HO, WO, Cout,
    # Cout_pad, KH, KW, stride, dil, pad_h, pad_w, split; the stream
    lib.conv_s8.argtypes = [p] * 8 + [i] * 15 + [p]
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
    """The plain int8 conv: x_q (N, H, W, C_in) int8 NHWC, w_q (KH, KW,
    C_in, C_out) int8 HWIO, zero ``padding`` (int, or ((top, bottom),
    (left, right))), ``stride``; pad with zeros, a float64 conv of the int8
    values (exact), the int32 sums, the epilogue: (N, H_out, W_out, C_out)
    in ``out_dtype``."""
    (hl, hh), (wl, wh) = _pads(padding)
    x = F.pad(x_q.permute(0, 3, 1, 2).double(), (wl, wh, hl, hh))
    acc = F.conv2d(x, w_q.permute(3, 2, 0, 1).double(), stride=stride)
    return _epilogue(acc.to(torch.int32).permute(0, 2, 3, 1), deq, bias,
                     out_dtype)


def conv_transpose2d_int8_reference(x_q, w_q, deq, bias=None, stride=2,
                                    padding=1, output_padding=1,
                                    out_dtype=torch.bfloat16):
    """The plain int8 ConvTranspose2d(k, stride, padding, output_padding)
    with the flipped HWIO kernel w_q (the JAX layout): the input dilated by
    ``stride`` (zeros between the values), padded by (k - 1 - padding, k - 1
    - padding + output_padding), a float64 conv (exact), the int32 sums,
    the epilogue: (N, (H - 1) stride - 2 padding + k + output_padding, ...,
    C_out)."""
    n, h, w, c = x_q.shape
    lo, hi = _transpose_pads(w_q.shape[0], padding, output_padding)
    xd = torch.zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1),
                     dtype=torch.float64, device=x_q.device)
    xd[:, :, ::stride, ::stride] = x_q.permute(0, 3, 1, 2).double()
    xd = F.pad(xd, (lo, hi, lo, hi))
    acc = F.conv2d(xd, w_q.permute(3, 2, 0, 1).double())
    return _epilogue(acc.to(torch.int32).permute(0, 2, 3, 1), deq, bias,
                     out_dtype)


def quantize_reference(x, qc):
    """The plain quantize of the kernel's front end: x (N, H, W, C_in) NHWC
    -> (x_q (N, H, W, C_in) int8, deq): by qc's static scale (deq = w_s) or
    per sample (deq = s w_s, (N, C_out))."""
    xc = x.permute(0, 3, 1, 2)
    if qc.static:
        q, deq = quant.quant_act_static(xc, qc.inv_a), qc.w_s
    else:
        q, s = quant.quant_act_dynamic(xc)
        deq = s[:, None] * qc.w_s[None]
    return q.permute(0, 2, 3, 1).contiguous(), deq


def sample_absmax_reference(x):
    """max |x| over each sample, float32 (N,)."""
    return x.float().abs().amax(dim=tuple(range(1, x.dim())))


def sample_absmax(x):
    """max |x| over each sample of x (N, ...), float32 (N,): the dynamic
    scales' max pass (``csrc/conv_s8.cu`` conv_s8_absmax_kernel, counted in
    ``sample_absmax.launches``) for a contiguous bf16 CUDA x with a multiple
    of 8 elements per sample; its plain version for a CPU tensor."""
    if x.device.type == 'cpu':
        return sample_absmax_reference(x)
    if x.device.type != 'cuda':
        raise ValueError(f'sample_absmax runs on cpu or cuda, got {x.device}')
    per = x[0].numel()
    if (x.dtype != torch.bfloat16 or not x.is_contiguous() or per % 8
            or x.data_ptr() % 16):
        raise ValueError(f'the max pass takes contiguous bf16 with a multiple '
                         f'of 8 elements per sample, got {x.dtype} '
                         f'{tuple(x.shape)}')
    amax = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().conv_s8_absmax(
            x.data_ptr(), amax.data_ptr(), x.shape[0], per,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'conv_s8_absmax launch failed: cudaError {err}')
    cuda_build.count(sample_absmax)
    return amax


sample_absmax.launches = 0


def conv_s8(x, qc, bias, *, stride, dil, pad, out_hw):
    """Launch ``csrc/conv_s8.cu`` on the current stream: quantize x (N, H,
    W, C_in) bf16 CUDA, NHWC contiguous, by qc (``quant.Int8Conv``: static
    scales, or per sample after the max pass ``sample_absmax``), then the
    conv with qc's packed kernel at ``stride`` over the input dilated by
    ``dil`` (one of the two 1), zero padding ``pad`` = (top, left) and
    output size ``out_hw``, then the epilogue with ``bias`` (C_out,) or
    None; returns (N, H_out, W_out, C_out) bf16. Counts the launch in
    ``conv_s8.launches``; raises on anything the kernel does not take
    (C_in % 8, C_out % 8, C_in > 2048, 16-byte alignment, a dtype other
    than bf16) or a failed launch."""
    if x.device.type != 'cuda':
        raise ValueError(f'conv_s8 launches on cuda, got {x.device}')
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise TypeError(f'conv_s8 takes contiguous NHWC bf16 x, got '
                        f'{x.dtype} {tuple(x.shape)}')
    n, h, w, cin = x.shape
    kh, kw, wcin, cout = qc.w_q.shape
    wpk = qc.w_pk
    if (wcin != cin or wpk.device != x.device or wpk.dtype != torch.int8
            or tuple(wpk.shape[:3]) != (kh, kw, -(-cin // quant.S8_KC))):
        raise ValueError(f'the packed kernel ({tuple(wpk.shape)}, {wpk.dtype}'
                         f' on {wpk.device}) does not fit x (C_in={cin}) on '
                         f'{x.device}')
    if cin % 8 or cout % 8 or cin > 2048 or x.data_ptr() % 16:
        raise ValueError(f'the conv_s8 kernel needs C_in % 8 == 0, C_in <= '
                         f'2048, C_out % 8 == 0 and a 16-byte aligned x, got '
                         f'C_in={cin}, C_out={cout}')
    if qc.static:
        inv, amax = qc.inv_c.to(x.device), None
        if inv.dtype != torch.bfloat16 or tuple(inv.shape) != (cin,):
            raise TypeError(f'inv_c must be ({cin},) bf16, got {inv.dtype} '
                            f'{tuple(inv.shape)}')
    else:
        inv, amax = None, sample_absmax(x)
    w_s = qc.w_s.to(device=x.device, dtype=torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.bfloat16).contiguous()
        if tuple(bias.shape) != (cout,):
            raise ValueError(f'bias must be ({cout},), got '
                             f'{tuple(bias.shape)}')
    ho, wo = out_hw
    geom = (n, h, w, cin, ho, wo, cout, kh, kw, stride, dil, pad[0], pad[1])
    lib = _lib()
    with torch.cuda.device(x.device):
        split = _split(x.device.index, geom)
        if split < 1:
            raise ValueError(f'the conv_s8 kernel does not take {geom}')
        y = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16,
                        device=x.device)
        ws = (torch.empty((n, ho, wo, cout), dtype=torch.int32,
                          device=x.device) if split > 1 else None)
        err = lib.conv_s8(
            x.data_ptr(), wpk.data_ptr(), w_s.data_ptr(),
            None if inv is None else inv.data_ptr(),
            None if amax is None else amax.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), n, h, w, cin, ho, wo, cout,
            wpk.shape[3] // quant.S8_KC, kh, kw, stride, dil, pad[0], pad[1],
            split, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'conv_s8 kernel launch failed: cudaError {err}')
    cuda_build.count(conv_s8)
    return y


conv_s8.launches = 0


@functools.lru_cache(maxsize=None)
def _split(device_index, geom):
    """The kernel's K split for ``geom`` on a device (its SM count is
    part of the plan), once per shape."""
    return _lib().conv_s8_split(*geom)


def _route(x):
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'int8 convs run on cpu or cuda, got {x.device}')
    return x.device.type == 'cpu'


def conv2d_s8_reference(x, qc, bias=None, stride=1, padding=0):
    """Plain PyTorch version of ``conv2d_s8`` (same signature and result):
    ``quantize_reference``, then ``conv2d_int8_reference``."""
    q, deq = quantize_reference(x, qc)
    return conv2d_int8_reference(q, qc.w_q, deq, bias, stride, padding,
                                 x.dtype)


def conv_transpose2d_s8_reference(x, qc, bias=None, stride=2, padding=1,
                                  output_padding=1):
    """Plain PyTorch version of ``conv_transpose2d_s8`` (same signature and
    result): ``quantize_reference``, then
    ``conv_transpose2d_int8_reference``."""
    q, deq = quantize_reference(x, qc)
    return conv_transpose2d_int8_reference(q, qc.w_q, deq, bias, stride,
                                           padding, output_padding, x.dtype)


def conv2d_s8(x, qc, bias=None, stride=1, padding=0):
    """int8 conv of x (N, H, W, C_in) NHWC by the quantized conv qc
    (``quant.Int8Conv``): zero ``padding`` (int, or ((top, bottom), (left,
    right))), ``stride``; returns (N, H_out, W_out, C_out) in x.dtype. A
    CPU tensor runs the plain version, a CUDA tensor the kernel."""
    if _route(x):
        return conv2d_s8_reference(x, qc, bias, stride, padding)
    (hl, hh), (wl, wh) = _pads(padding)
    _, h, w, _ = x.shape
    kh, kw = qc.w_q.shape[:2]
    out_hw = ((h + hl + hh - kh) // stride + 1,
              (w + wl + wh - kw) // stride + 1)
    return conv_s8(x, qc, bias, stride=stride, dil=1, pad=(hl, wl),
                   out_hw=out_hw)


def conv_transpose2d_s8(x, qc, bias=None, stride=2, padding=1,
                        output_padding=1):
    """int8 ConvTranspose2d(k, stride, padding, output_padding) of x (N, H,
    W, C_in) NHWC by qc (its kernel flipped HWIO, the JAX layout): the conv
    of the input dilated by ``stride``; returns (N, (H - 1) stride - 2
    padding + k + output_padding, ..., C_out) in x.dtype. The kernel skips
    the dilation's zero taps. A CPU tensor runs the plain version, a CUDA
    tensor the kernel."""
    if _route(x):
        return conv_transpose2d_s8_reference(x, qc, bias, stride, padding,
                                             output_padding)
    _, h, w, _ = x.shape
    kh, kw = qc.w_q.shape[:2]
    lo_h, hi_h = _transpose_pads(kh, padding, output_padding)
    lo_w, hi_w = _transpose_pads(kw, padding, output_padding)
    out_hw = ((h - 1) * stride + 1 + lo_h + hi_h - kh + 1,
              (w - 1) * stride + 1 + lo_w + hi_w - kw + 1)
    return conv_s8(x, qc, bias, stride=1, dil=stride, pad=(lo_h, lo_w),
                   out_hw=out_hw)
