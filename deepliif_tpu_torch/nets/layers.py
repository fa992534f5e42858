"""Functional layer primitives, NCHW (PyTorch's layout).

Port of deepliif_tpu/nets/layers.py (the int8 calibration helpers and
the TPU lowering tricks aside). The
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
fixed-order kernel ``csrc/plane_stats.cu`` (``plane_mean_var``; torch's
CUDA mean splits its sum by the shape of the whole tensor); cuDNN picks
its algorithm by the shape of the call, so the engine runs a short batch
in a smaller bucket only where its probe holds it bitwise against the
full batch, each float32 cuDNN call whose bits would differ zero-padded
to the full batch (``cudnn_hook``, ``models.InferenceSession.probe_bucket``).
On the CPU, and in bf16 on CUDA, every conv and conv-transpose runs one
sample at a time (``_per_sample``): oneDNN also picks by shape, and a
cuDNN bf16 conv of 16 samples computed its last four otherwise. A
training step, which needs no batch invariance, runs its CUDA convs as
one call (``batched``).

Norms (``norm_layer`` / ``apply_norm``): 'batch' (per-sample statistics,
``batch_stat_norm``), 'instance' (``instance_norm``, the same statistics
kernel without the affine; the convs then carry a bias,
``norm_use_bias``), 'none', and 'spectral' (no norm layer; the DeepLIIF
family divides each conv weight by its spectral norm, ``SpectralCache``,
the JAX ``spectral_normalize_tree``). Pads: zero, reflect, replicate;
upsampling: ``upsample_nearest`` and ``pixel_shuffle`` besides the
conv-transpose.

``conv2d_s2d`` and ``conv_transpose2d_s2d`` of the JAX package are TPU
lowering tricks for a tiny output-channel count; their counterpart here is
the plain conv.

Training (the nets' train mode, float32 or bfloat16): ``init_net`` draws
every conv and norm parameter of a net as the JAX initializers do
(normal, xavier, kaiming, orthogonal; norm scale N(1, gain), bias 0) from
an explicit ``torch.Generator``; ``train_cast`` gives each conv its weight
and bias in the compute dtype under autograd (``train_dtype``; the
gradient reaches the float32 parameter through the cast), a weight with a
``spectral_u`` divided by its spectral norm first (``spectral_weight``:
the power iteration without gradient, sigma with it, as the JAX
``_sn_single`` under ``jax.grad``; ``draw_spectral_u`` and
``refresh_spectral_u`` draw and refresh u); ``dropout`` draws its mask
from a generator on the device; the norms take their statistics in
float32 through ``plane_mean_var_train``, an autograd Function whose
forward is the statistics kernel (float32 or bfloat16 input; its plain
version on the CPU) and whose backward is one elementwise pass; batch
norm couples the samples (``train_batch_norm``: statistics over (B, H,
W), the JAX ``batch_stat_norm(per_sample=False)``), built from the
per-sample statistics of one call.

int8: a conv given an ``ops.quant.Int8Conv`` in place of its weight takes
the JAX package's int8 route (layers.py conv2d, conv_transpose2d): the
input quantized (static scale, or per sample below the dynamic spatial
gate, else the float route), the int8 conv, in NHWC (``ops.conv_int8``:
the CUDA kernel ``csrc/conv_s8.cu``, which quantizes the bf16 input while
loading it; on the CPU its plain version, the quantize of ``int8_input``
then a float64 conv), the output a channels_last view. ``ActCalibration``
records conv inputs for static scales (the JAX ``act_calibration``),
handed down explicitly.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..ops import conv_int8, cuda_build, quant
from ..utils.checkpoints import weight_from_hwio, weight_to_hwio

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


class Int8Cache:
    """The ``quant.Int8Conv`` of each quantized conv of a net, built once per
    weight version (a net makes a new cache when its scales change)."""

    def __init__(self):
        self._key = None
        self._convs = {}

    def get(self, convs, scales, dtype):
        """convs: [(name, weight, kind)] (kind conv or convT, torch layout),
        each name a key of ``scales`` ({name: calibrated max |x| of the
        conv's input, or None for dynamic scales}) -> {id(weight):
        Int8Conv} with float weights in ``dtype``."""
        key = (dtype,) + tuple((n, w.data_ptr(), w._version)
                               for n, w, _ in convs)
        if key != self._key:
            with torch.no_grad():
                self._convs = {
                    id(w): quant.quantize_conv(
                        w.detach(), weight_to_hwio(w.detach(), kind).float(),
                        scales[n], dtype)
                    for n, w, kind in convs}
            self._key = key
        return self._convs


def cast_function(casts, q, spectral=False):
    """Function param -> what its conv takes: ``q[id(param)]`` (an
    ``Int8Conv``) for a quantized conv, else ``casts[id(param)]`` (the
    compute-dtype copy, or the spectrally normalized weight), else the
    param itself; None stays None. With ``spectral`` the float route of a
    quantized conv (past the dynamic gate) takes the normalized weight,
    while its int8 weights come from the raw one: the JAX package
    quantizes its params at load and normalizes only the float weights in
    the forward."""
    if spectral:
        q = {k: dataclasses.replace(v, w=casts.get(k, v.w))
             for k, v in q.items()}
    return lambda p: None if p is None else (
        q[id(p)] if id(p) in q else casts.get(id(p), p))


# the engine's hook around each batched library call of a bucket's
# forward (``cudnn_hook``)
_CUDNN_HOOK = contextvars.ContextVar('cudnn_hook', default=None)


@contextlib.contextmanager
def cudnn_hook(hook):
    """Route every conv and conv-transpose of the float route, and every
    ``batch_call``, through ``hook(run, x, key, axis)`` in the block (this
    thread): ``run(t)`` computes the call on an input ``t`` of any batch
    (along ``axis`` of the input, axis 0 of the output), ``key`` names the
    call by everything but its batch (kind, per-sample shape and strides,
    dtype, weight shape, stride and padding). ``None``: no hook."""
    token = _CUDNN_HOOK.set(hook)
    try:
        yield
    finally:
        _CUDNN_HOOK.reset(token)


def batch_call(run, x, key, axis=0):
    """``run(x)``, through the engine's ``cudnn_hook`` where one is set: a
    library call whose result for a sample may depend on the batch (its
    batch on ``axis`` of x, on axis 0 of the result)."""
    hook = _CUDNN_HOOK.get()
    return run(x) if hook is None else hook(run, x, key, axis)


def _aligned(x):
    """x, or a copy of it where its data does not start 16-byte aligned
    (cuDNN also picks its algorithm by the alignment of the data: a bf16
    sample of the padded 3-channel head input starts 8 bytes off for odd
    tiles)."""
    return x if x.device.type == 'cpu' or x.data_ptr() % 16 == 0 else \
        x.clone()


# a training step's bf16 convs on CUDA run as one call (``batched``)
_BATCHED = contextvars.ContextVar('batched', default=False)


@contextlib.contextmanager
def batched():
    """In the block (this thread), a bf16 conv on CUDA runs as one call:
    a training step needs no batch invariance (its batch norm couples the
    samples anyway), and a full-width bf16 flagship step ran faster with
    one call per conv than one sample at a time, both bitwise
    reproducible (``experiments/torch_train_bf16_convs.py``; PERF.md)."""
    token = _BATCHED.set(True)
    try:
        yield
    finally:
        _BATCHED.reset(token)


def _per_sample(fn, x, *args):
    """``fn(x, *args)``. On the CPU, and in bf16 on CUDA outside
    ``batched``, one sample at a time, each 16-byte aligned: every call
    then has the shape of one tile, so a tile's result does not depend on
    the batch (oneDNN and cuDNN pick their algorithm by the shape of the
    whole call, and on the H100 a cuDNN bf16 conv of a batch of 16 gave
    its last four samples other bits than the same samples alone,
    ``chip_smoke.py`` phase ``pipeline``). Otherwise one call, through
    the engine's ``cudnn_hook`` where one is set
    (``models._BatchFloors``)."""
    if x.device.type == 'cpu' or (x.dtype != torch.float32
                                  and not _BATCHED.get()):
        if x.shape[0] == 1:
            return fn(_aligned(x), *args)
        return torch.cat([fn(_aligned(x[i:i + 1]), *args)
                          for i in range(x.shape[0])])
    key = (fn.__name__, tuple(x.shape[1:]), x.stride()[1:], x.dtype,
           tuple(args[0].shape), args[2:])
    return batch_call(lambda t: fn(t, *args), x, key)


def _nhwc(x):
    """x (N, C, H, W) -> (N, H, W, C) contiguous: a view of channels_last
    memory, else a copy counted in ``int8_input.relayouts``."""
    xh = x.permute(0, 2, 3, 1)
    if not xh.is_contiguous():
        cuda_build.count(int8_input, 'relayouts')
        xh = xh.contiguous()
    return xh


def int8_input(x, qc):
    """The plain quantize of the int8 route: x (N, C, H, W) -> (x_q (N, H,
    W, C) int8 NHWC contiguous, deq), by qc's static scale (deq = w_s) or
    per sample (deq = s w_s, (N, C_out)). On CUDA the conv_s8 kernel
    quantizes while loading instead; ``int8_input.relayouts`` counts the
    int8 route's inputs that were not channels_last and so copied to
    NHWC."""
    return conv_int8.quantize_reference(_nhwc(x), qc)


int8_input.relayouts = 0


def conv2d(x, weight, bias=None, stride=1, padding=0):
    """2D conv in x.dtype; ``padding`` int means symmetric zero pad (torch
    semantics); the bias is added after the conv. ``weight`` an
    ``Int8Conv``: the int8 route where ``quant.int8_ok`` admits x, else the
    float route with its float weight."""
    if isinstance(weight, quant.Int8Conv):
        if quant.int8_ok(x, weight.static):
            return conv_int8.conv2d_s8(_nhwc(x), weight, bias, stride,
                                       padding).permute(0, 3, 1, 2)
        weight = weight.w
    out = _per_sample(F.conv2d, x, weight, None, stride, padding)
    return out if bias is None else out + bias[None, :, None, None]


def _channels_last_1x1(x):
    """x (S, C, 1, 1) viewed with channels_last strides (no copy: both
    layouts hold the same bytes). An elementwise op gives such a tensor
    NCHW strides; cuDNN then runs the conv-transpose and the rest of the
    unet's up path in NCHW, converting to and from NHWC around each bf16
    call."""
    if x.dim() != 4 or x.shape[2:] != (1, 1) or not x.is_contiguous():
        return x
    c = x.shape[1]
    return x.as_strided(x.shape, (c, 1, c, c))


def conv_transpose2d(x, weight, bias=None, stride=2, padding=1,
                     output_padding=1):
    """torch ConvTranspose2d with an IOHW weight:
    out = (in - 1) * stride - 2 * padding + k + output_padding; the bias is
    added after the conv. On CUDA in bfloat16 a 1x1 input (the unet_512's
    innermost block) keeps channels_last, so the output does and cuDNN
    runs its NHWC tensor-core kernels. float32 stays NCHW there: cuDNN's
    float32 conv-transpose is NCHW-native, and a unet_512 runs slower
    with the re-view on the H100 (``experiments/torch_segnet_spread.py
    --layout``). ``weight`` an ``Int8Conv``: as in ``conv2d``."""
    if isinstance(weight, quant.Int8Conv):
        if quant.int8_ok(x, weight.static):
            return conv_int8.conv_transpose2d_s8(
                _nhwc(x), weight, bias, stride, padding,
                output_padding).permute(0, 3, 1, 2)
        weight = weight.w
    if x.device.type == 'cuda' and x.dtype != torch.float32:
        x = _channels_last_1x1(x)
    out = _per_sample(F.conv_transpose2d, x, weight, None, stride, padding,
                      output_padding)
    return out if bias is None else out + bias[None, :, None, None]


def _percentile(a, pct):
    """Per-row ``pct`` percentile of a (C, n) float32: jnp.percentile's
    default, linear interpolation between the order statistics at
    position q (n - 1), q = pct / 100, with q, the position and the weights
    in float32."""
    f32 = np.float32
    pos = f32(f32(pct) / f32(100.0)) * f32(a.shape[1] - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = f32(pos - f32(lo))
    srt = a.sort(dim=1).values
    return srt[:, lo] * float(f32(1.0) - w_hi) + srt[:, hi] * float(w_hi)


def record(calib, name, x):
    """``calib.record(name, x)`` where a calibration is running."""
    if calib is not None:
        calib.record(name, x)


class ActCalibration:
    """Per-conv input ranges for static int8 scales, the JAX package's
    ``act_calibration``: nets call ``record(key, x)`` with each conv's input
    x (N, C, H, W) as the conv sees it (after any pad the net applies
    first, before a pad inside the conv); ``keys`` holds the convs the
    min_ch gate admits (JAX param paths such as 'G/down0_conv'), others
    are ignored. Ranges max-merge into ``out`` across calls:
    per-input-channel max |x| (``per_channel``), or its ``pct`` percentile
    over the call's samples and pixels when ``pct`` < 100; per tensor, the
    max |x| (``pct`` ignored, as in the JAX package). ``at(prefix)`` is
    the view a net records through, by its own conv names."""

    def __init__(self, keys, out=None, per_channel=True, pct=100.0):
        self.keys = set(keys)
        self.out = {} if out is None else out
        self.per_channel = per_channel
        self.pct = float(pct)

    def at(self, prefix):
        return _CalibrationView(self, prefix)

    def record(self, key, x):
        if key not in self.keys:
            return
        a = x.detach().float().abs()
        if not self.per_channel:
            prev = self.out.get(key, 0.0)
            self.out[key] = max(float(np.max(prev)), float(a.max()))
            return
        flat = a.transpose(0, 1).reshape(a.shape[1], -1)
        m = (flat.amax(dim=1) if self.pct >= 100.0
             else _percentile(flat, self.pct))
        m = m.cpu().numpy().astype(np.float32)
        prev = self.out.get(key)
        self.out[key] = m if prev is None else np.maximum(
            np.asarray(prev, np.float32), m)


class _CalibrationView:
    def __init__(self, calib, prefix):
        self.calib, self.prefix = calib, prefix

    def record(self, name, x):
        self.calib.record(f'{self.prefix}/{name}', x)


def pad2d(x, n, mode='zero'):
    """Pad H and W by ``n``: 'zero', 'reflect' or 'replicate' (the edge
    value, ``jnp.pad`` mode 'edge')."""
    if mode == 'zero':
        return F.pad(x, (n, n, n, n))
    if mode in ('reflect', 'replicate'):
        return F.pad(x, (n, n, n, n), mode=mode)
    raise NotImplementedError(f'padding [{mode}] not implemented')


def pad_layer(n, mode):
    """The reference's pad module for ``mode``: it holds no parameters, so
    it only keeps the indices of the reference ``nn.Sequential``."""
    return {'reflect': nn.ReflectionPad2d, 'replicate': nn.ReplicationPad2d,
            'zero': nn.ZeroPad2d}[mode](n)


def upsample_nearest(x, factor=2):
    """Nearest-neighbour upsampling of (N, C, H, W) by ``factor``."""
    return F.interpolate(x, scale_factor=factor, mode='nearest')


def pixel_shuffle(x, factor=2):
    """torch PixelShuffle: (N, C r^2, H, W) -> (N, C, H r, W r)."""
    return F.pixel_shuffle(x, factor)


# the statistics kernel's chunk layout, decided here only: 16-byte loads a
# thread and threads a block (the array sizes csrc/plane_stats.cu is built
# on; it refuses a geometry that does not fit them), at least
# _PLANE_MIN_BLOCKS blocks per sample where the plane is small, and the
# runs of chunks the merge takes per channel before it merges the runs
_PLANE_LOADS, _PLANE_THREADS, _PLANE_MIN_BLOCKS, _PLANE_SEG = 16, 256, 16, 16


@functools.cache
def _lib():
    lib = cuda_build.load('plane_stats', _LIBS['plane_stats'])
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.plane_stats_f32, lib.plane_stats_bf16):
        fn.argtypes = [p, p, p] + [i] * 9 + [p]
        fn.restype = i
    return lib


def _plane_geometry(p, c, elem, nchw=False):
    """(G, rows, chunk_px, n_chunks) of the statistics kernel for a plane
    of ``p`` pixels x ``c`` channels of ``elem`` bytes. NHWC memory: a block
    holds ``rows`` pixel lanes x G 16-byte channel units, a chunk is rows *
    _PLANE_LOADS pixels, and G is halved while a sample would have fewer
    than _PLANE_MIN_BLOCKS blocks (the unet_512's innermost planes: 2x2 to
    8x8 at 512 channels). NCHW memory (``nchw``; G = rows = 0): a block
    holds _PLANE_THREADS x _PLANE_LOADS loads of 16 bytes of one plane, or
    of one value where a plane of p values is not a multiple of 16 bytes.
    A function of
    the plane alone, never of the batch, so a sample's statistics do not
    depend on the batch it rides in."""
    if nchw:
        per_load = 16 // elem if (p * elem) % 16 == 0 else 1
        chunk = _PLANE_THREADS * _PLANE_LOADS * per_load
        return 0, 0, chunk, -(-p // chunk)
    units = c // (16 // elem)
    g = min(units, 32)
    while True:
        rows = _PLANE_THREADS // g
        chunk = rows * _PLANE_LOADS
        n_chunks = -(-p // chunk)
        if g == 1 or -(-units // g) * n_chunks >= _PLANE_MIN_BLOCKS:
            return g, rows, chunk, n_chunks
        g = -(-g // 2)


def plane_mean_var_reference(x):
    """Plain PyTorch version of ``plane_mean_var`` (same signature and
    result): the JAX package's two-pass formula in float32 (float64 for a
    float64 x), the mean, then the mean of (x - mean)^2."""
    d = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = d.mean(dim=(2, 3))
    var = ((d - mean[:, :, None, None]) ** 2).mean(dim=(2, 3))
    return torch.stack([mean, var], dim=1)


def plane_mean_var(x):
    """Per-(sample, channel) mean and biased variance over the spatial
    plane, in float32: (S, 2, C) [mean, var], var the mean of (x - mean)^2
    (not E[x^2] - mean^2). x: (S, C, H, W) float32 or bfloat16 (on CUDA in
    channels_last memory with C % 8 for bfloat16, % 4 for float32, or in
    NCHW memory). A CPU tensor runs the plain version; a CUDA tensor
    launches the one-read fixed-order kernel (``csrc/plane_stats.cu``: its
    statistics do not depend on the batch) on the current stream and counts
    it in ``plane_mean_var.launches``, or raises. A CUDA x in any other
    layout (or a view not 16-byte aligned) is copied to channels_last first
    and counted in ``plane_mean_var.relayouts``."""
    if x.device.type == 'cpu':
        return plane_mean_var_reference(x)
    if x.device.type != 'cuda':
        raise ValueError(f'plane_mean_var runs on cpu or cuda, got '
                         f'{x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise TypeError(f'plane_mean_var takes (S, C, H, W) float32 or '
                        f'bfloat16, got {x.dtype} {tuple(x.shape)}')
    s_n, c, h, w = x.shape
    elem = x.element_size()
    aligned = x.data_ptr() % 16 == 0
    if (aligned and c % (16 // elem) == 0
            and x.is_contiguous(memory_format=torch.channels_last)):
        nchw = False
    elif aligned and x.is_contiguous():
        nchw = True
    else:
        if c % (16 // elem):
            raise ValueError(f'the plane_stats kernel reads channels_last '
                             f'memory with C % {16 // elem} == 0 at '
                             f'{x.dtype}, or NCHW memory; got C={c}')
        cuda_build.count(plane_mean_var, 'relayouts')
        x = x.contiguous(memory_format=torch.channels_last)
        nchw = False
    g, rows, chunk, n_chunks = _plane_geometry(h * w, c, elem, nchw)
    lib = _lib()
    on_x = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((s_n, n_chunks, 2, c), **on_x)
    stats = torch.empty((s_n, 2, c), **on_x)
    fn = lib.plane_stats_bf16 if x.dtype == torch.bfloat16 else \
        lib.plane_stats_f32
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), partial.data_ptr(), stats.data_ptr(), s_n,
                 h * w, c, int(nchw), g, rows, chunk, n_chunks, _PLANE_SEG,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'plane_stats kernel launch failed: cudaError '
                           f'{err}')
    cuda_build.count(plane_mean_var)
    return stats


plane_mean_var.launches = 0
plane_mean_var.relayouts = 0


def plane_sums(x):
    """Per-(sample, channel) sums over the spatial plane, in float32:
    (S, 2, C) [sum of x, sum of x^2], the statistics of the fused
    translator head, from one ``plane_mean_var`` call: sum = P mean, sum of
    squares = P (var + mean^2)."""
    st = plane_mean_var(x)
    p = x.shape[2] * x.shape[3]
    mean, var = st[:, 0], st[:, 1]
    return torch.stack([mean * p, (var + mean * mean) * p], dim=1)


class _PlaneMeanVar(torch.autograd.Function):
    """``plane_mean_var`` with a gradient: the forward is the statistics
    kernel (on the CPU its plain version), the backward one elementwise
    pass, dx = (g_mean + 2 g_var (x - mean)) / P over the P pixels of a
    plane (the XLA fusion of the JAX package's backward; no TPU kernel)."""

    @staticmethod
    def forward(ctx, x):
        st = plane_mean_var(x)
        ctx.save_for_backward(x, st)
        return st

    @staticmethod
    def backward(ctx, g):
        x, st = ctx.saved_tensors
        p = x.shape[2] * x.shape[3]
        gm, gv = g[:, 0, :, None, None], g[:, 1, :, None, None]
        dx = (gm + 2 * gv * (x - st[:, 0, :, None, None])) / p
        return dx.to(x.dtype)


def plane_mean_var_train(x):
    """``plane_mean_var`` under autograd (the train-mode norms)."""
    return _PlaneMeanVar.apply(x)


def batch_stat_norm(x, scale, bias, eps=1e-5):
    """BatchNorm2d with batch statistics (biased variance), affine, with the
    statistics taken per sample (over H, W): the reference inference
    semantics, where every tile is a batch of one with running stats
    disabled (deepliif_tpu ``batch_stat_norm(per_sample=True)``). Tiles of a
    batch must not couple through the norm, so ``nn.BatchNorm2d`` in train
    mode is never used for inference. Statistics (the mean and the mean of
    (x - mean)^2, one ``plane_mean_var`` call), scale and bias are computed
    in float32, then cast to x.dtype for ``x * scale + bias``."""
    st = plane_mean_var(x)
    return _affine(x, st[:, 0], st[:, 1], scale, bias, eps)


def _affine(x, mean, var, scale, bias, eps):
    """x * s + b with s = scale / sqrt(var + eps), b = bias - mean s, the
    statistics (S, C) or (C,) and s, b computed in float32."""
    mean = mean.reshape(-1, mean.shape[-1], 1, 1)
    inv = torch.rsqrt(var.reshape(mean.shape) + eps)
    s = inv * scale[None, :, None, None]
    b = bias[None, :, None, None] - mean * inv * scale[None, :, None, None]
    return x * s.to(x.dtype) + b.to(x.dtype)


def train_batch_norm(x, scale, bias, eps=1e-5):
    """Train-mode BatchNorm2d: statistics over (B, H, W), coupling the
    samples (the JAX ``batch_stat_norm(per_sample=False)``), from one
    ``plane_mean_var_train`` call: mean the mean of the per-sample means,
    var the mean of (var_s + (mean_s - mean)^2). Under data parallelism
    (``parallel.data_parallel``) the per-sample statistics of every rank,
    in rank order (``parallel.gather_rows``): the global batch's, as the
    JAX step's under GSPMD."""
    st = parallel.gather_rows(plane_mean_var_train(x))
    mean_s, var_s = st[:, 0], st[:, 1]
    mean = mean_s.mean(0)
    var = (var_s + (mean_s - mean) ** 2).mean(0)
    return _affine(x, mean, var, scale, bias, eps)


def instance_norm(x, eps=1e-5, train=False):
    """InstanceNorm2d(affine=False): per-sample, per-channel statistics over
    H, W (one ``plane_mean_var`` call, the statistics kernel on CUDA;
    ``train``: through ``plane_mean_var_train``), in float32; x * scale +
    bias in x.dtype."""
    st = (plane_mean_var_train if train else plane_mean_var)(x)
    mean, var = st[:, 0][:, :, None, None], st[:, 1][:, :, None, None]
    inv = torch.rsqrt(var + eps)
    return x * inv.to(x.dtype) + (-mean * inv).to(x.dtype)


def norm_layer(norm, c):
    """The reference's norm module for ``norm`` at ``c`` channels:
    BatchNorm2d with its affine parameters (statistics per sample,
    ``batch_stat_norm``, or over the batch in training), InstanceNorm2d
    without parameters, or an empty slot ('none'; 'spectral' normalizes the
    conv weights instead)."""
    if norm == 'batch':
        return nn.BatchNorm2d(c, affine=True, track_running_stats=False)
    if norm == 'instance':
        return nn.InstanceNorm2d(c)
    if norm in ('none', 'spectral'):
        return nn.Identity()
    raise NotImplementedError(f'norm [{norm}] not implemented')


def norm_use_bias(norm):
    """Convs carry a bias iff the norm is instance norm (the reference rule
    use_bias = norm_layer == nn.InstanceNorm2d)."""
    return norm == 'instance'


def apply_norm(x, norm, layer, train=False):
    """The norm of ``norm`` with the parameters of ``layer``
    (``norm_layer``'s module): inference statistics per sample, or with
    ``train`` the train-mode norm (batch statistics over the batch, under
    autograd)."""
    if norm == 'batch':
        if train:
            return train_batch_norm(x, layer.weight, layer.bias)
        return batch_stat_norm(x, layer.weight, layer.bias)
    if norm == 'instance':
        return instance_norm(x, train=train)
    if norm in ('none', 'spectral'):
        return x
    raise NotImplementedError(f'norm [{norm}] not implemented')


# spectral normalization (norm 'spectral', DeepLIIF family): each conv
# keeps the power-iteration vector of the JAX package's param tree ('u',
# over the rows of the HWIO kernel reshaped to (KH KW C_in, C_out)) as the
# buffer ``spectral_u`` of its module
SPECTRAL_ITERS = 3


def conv_modules(net):
    """[(module, kind)] of every conv ('conv') and conv-transpose ('convT')
    of ``net``."""
    return [(m, 'convT' if isinstance(m, nn.ConvTranspose2d) else 'conv')
            for m in net.modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]


def add_spectral_buffers(net):
    """Give every conv of ``net`` a ``spectral_u`` buffer (zeros until
    loaded; ``KH KW C_in`` long)."""
    for m, kind in conv_modules(net):
        w = m.weight
        cin = w.shape[1] if kind == 'conv' else w.shape[0]
        m.register_buffer('spectral_u', torch.zeros(
            w.shape[2] * w.shape[3] * cin))


def drop_spectral_buffers(net):
    """Remove the ``spectral_u`` buffers: the convs then run their weights
    as they are (the JAX package imports a reference dir without 'u')."""
    for m, _ in conv_modules(net):
        if 'spectral_u' in m._buffers:
            del m._buffers['spectral_u']


def spectral_sigma(w_hwio, u, n_iter=SPECTRAL_ITERS):
    """The JAX package's ``_sn_single``: ``n_iter`` power-iteration steps
    from ``u`` on the (KH KW C_in, C_out) matrix of the HWIO kernel, in
    float32; returns sigma = u' M v."""
    mat = w_hwio.reshape(-1, w_hwio.shape[-1]).float()
    u, v = _power_iteration(mat, u.float(), n_iter)
    return u @ (mat @ v)


def _power_iteration(mat, u, n_iter):
    """(u', v') after ``n_iter`` steps from ``u`` on ``mat`` (the JAX
    ``_sn_single`` loop)."""
    v = None
    for _ in range(n_iter):
        v = mat.T @ u
        v = v / (torch.linalg.norm(v) + 1e-12)
        u = mat @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
    return u, v


def _spectral_matrix(m, kind):
    """The (KH KW C_in, C_out) matrix of a conv module's HWIO kernel, in
    float32 (float64 for a float64 weight)."""
    w = weight_to_hwio(m.weight, kind)
    return w.reshape(-1, w.shape[-1]).to(
        torch.promote_types(w.dtype, torch.float32))


def spectral_weight(m, kind, n_iter=SPECTRAL_ITERS):
    """The conv module ``m``'s weight divided by its spectral norm, under
    autograd (train mode; the JAX ``_sn_single`` under ``jax.grad``): the
    power iteration from ``m.spectral_u`` runs without gradient (JAX's
    stop_gradient on u' and v'), sigma = u' M v' keeps M's, so the gradient
    flows through w / sigma(w). ``spectral_u`` is not changed
    (``refresh_spectral_u`` does that once a step)."""
    mat = _spectral_matrix(m, kind)
    with torch.no_grad():
        u, v = _power_iteration(mat, m.spectral_u.to(mat.dtype), n_iter)
    return m.weight / (u @ (mat @ v)).to(m.weight.dtype)


def draw_spectral_u(net, generator=None):
    """Draw every ``spectral_u`` of ``net`` from N(0, 1) (float32, on the
    CPU; the JAX ``add_spectral_u`` at init)."""
    with torch.no_grad():
        for m, _ in conv_modules(net):
            if 'spectral_u' in m._buffers:
                m.spectral_u.copy_(torch.randn(m.spectral_u.shape,
                                               generator=generator))


def refresh_spectral_u(net, n_iter=SPECTRAL_ITERS):
    """u <- ``n_iter`` power-iteration steps from u on the current weight,
    for every conv of ``net`` with a ``spectral_u``: the refreshed vectors
    of the JAX ``spectral_normalize_tree``, which its DeepLIIF step keeps
    once a step after both updates."""
    with torch.no_grad():
        for m, kind in conv_modules(net):
            if 'spectral_u' in m._buffers:
                mat = _spectral_matrix(m, kind)
                u, _ = _power_iteration(mat, m.spectral_u.to(mat.dtype),
                                        n_iter)
                m.spectral_u.copy_(u)


# convs take their weights as they are, spectral_u or not
# (``raw_weights``)
_RAW_WEIGHTS = contextvars.ContextVar('raw_weights', default=False)


@contextlib.contextmanager
def raw_weights():
    """In the block (this thread), convs skip the spectral normalization
    (``spectral_on`` is False): the JAX DeepLIIFKD G loss runs its student,
    and its teacher its seg branches, on the raw weights
    (``models.deepliif_kd``)."""
    token = _RAW_WEIGHTS.set(True)
    try:
        yield
    finally:
        _RAW_WEIGHTS.reset(token)


def spectral_on():
    """Convs with a ``spectral_u`` normalize their weights (False inside
    ``raw_weights``)."""
    return not _RAW_WEIGHTS.get()


def train_dtype(net):
    """The dtype a net computes in train mode: its ``compute_dtype`` where
    that is bfloat16, else its parameters' (float32; float64 for a
    reference on the CPU)."""
    if net.compute_dtype != torch.float32:
        return net.compute_dtype
    return next(net.parameters()).dtype


def train_cast(net, dtype):
    """Function param -> what its conv takes in train mode, under autograd
    (the JAX ``w.astype(x.dtype)`` under ``jax.grad``): each conv weight
    spectrally normalized where its module has a ``spectral_u``
    (``spectral_weight``, unless ``raw_weights``), then, like each conv
    bias, cast to ``dtype``; the gradient reaches the float32 parameter
    through the cast. Made anew each call: the weights change every
    step."""
    casts = {}
    spectral = spectral_on()
    for m, kind in conv_modules(net):
        w = m.weight
        if spectral and 'spectral_u' in m._buffers:
            w = spectral_weight(m, kind)
        casts[id(m.weight)] = w.to(dtype)
        if m.bias is not None:
            casts[id(m.bias)] = m.bias.to(dtype)
    return lambda p: None if p is None else casts.get(id(p), p)


class SpectralCache:
    """The spectrally normalized weights of a net (weight / sigma, in
    float32, then cast to the compute dtype), rebuilt when a weight, a
    ``spectral_u`` or the dtype changes."""

    def __init__(self):
        self._key = None
        self._w = {}

    def get(self, net, dtype):
        """{id(weight): normalized weight in ``dtype``} of every conv of
        ``net`` that has a ``spectral_u`` buffer."""
        convs = [(m, kind) for m, kind in conv_modules(net)
                 if 'spectral_u' in m._buffers]
        key = (dtype,) + tuple(
            (t.data_ptr(), t._version) for m, _ in convs
            for t in (m.weight, m.spectral_u))
        if key != self._key:
            with torch.no_grad():
                self._w = {
                    id(m.weight): (m.weight / spectral_sigma(
                        weight_to_hwio(m.weight, kind), m.spectral_u))
                    .to(dtype).contiguous() for m, kind in convs}
            self._key = key
        return self._w


def dropout(x, rng, rate=0.5, train=False):
    """Train-mode dropout (the JAX ``dropout``): keep with probability 1 -
    ``rate``, the kept values divided by 1 - ``rate``; the mask drawn from
    ``rng``, a ``torch.Generator`` on x's device. x as it is outside
    ``train`` or at rate 0; in ``train`` without a generator it raises, so
    that a missing ``rng`` cannot switch dropout off. Under data
    parallelism the mask is this rank's rows of the global batch's mask
    (``parallel.global_rows``), the one-device step's."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError('train-mode dropout needs a torch.Generator (rng)')

    def draw(shape):
        if tuple(shape) == tuple(x.shape):
            t = torch.empty_like(x, dtype=torch.float32)
        else:   # the global batch's mask, laid out as x is
            cl = (x.dim() == 4 and not x.is_contiguous()
                  and x.is_contiguous(memory_format=torch.channels_last))
            t = torch.empty(shape, dtype=torch.float32, device=x.device,
                            memory_format=torch.channels_last if cl
                            else torch.contiguous_format)
        return t.uniform_(generator=rng)
    keep = parallel.global_rows(draw, x.shape) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# initializers (deepliif_tpu/nets/layers.py :37-77, reference networks.py
# :84-115): drawn in the JAX HWIO layout from a torch.Generator, so each
# init type has the JAX package's distribution (not its values)

def init_kernel(shape, init_type='normal', init_gain=0.02, generator=None):
    """A conv kernel of HWIO ``shape`` (float32, on the CPU)."""
    def normal(*s):
        return torch.randn(*s, generator=generator, dtype=torch.float32)

    fan_in = shape[0] * shape[1] * shape[2]
    fan_out = shape[0] * shape[1] * shape[3]
    if init_type == 'normal':
        return init_gain * normal(*shape)
    if init_type == 'xavier':
        return init_gain * (2.0 / (fan_in + fan_out)) ** 0.5 * normal(*shape)
    if init_type == 'kaiming':
        return (2.0 / fan_in) ** 0.5 * normal(*shape)
    if init_type == 'orthogonal':
        rows, cols = fan_in, shape[3]
        a = normal(rows, cols)
        q, r = torch.linalg.qr(a if rows >= cols else a.T)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (init_gain * q).reshape(shape)
    raise NotImplementedError(f'init [{init_type}] not implemented')


def init_net(net, init_type='normal', init_gain=0.02, generator=None):
    """Initialize every parameter of ``net`` (a module with ``jax_layout``)
    in place as the JAX package's ``init_conv`` / ``init_norm`` do: conv
    kernels by ``init_kernel`` (drawn in HWIO, then laid out as the
    module's), biases 0, norm scales N(1, ``init_gain``), norm biases 0."""
    with torch.no_grad():
        for _, prefix, kind in net.jax_layout():
            mod = net.get_submodule(prefix)
            if kind == 'norm':
                if getattr(mod, 'weight', None) is not None:
                    mod.weight.copy_(1.0 + init_gain * torch.randn(
                        mod.weight.shape, generator=generator))
                    mod.bias.zero_()
                continue
            hwio = weight_to_hwio(mod.weight, kind).shape
            mod.weight.copy_(weight_from_hwio(
                init_kernel(tuple(hwio), init_type, init_gain, generator),
                kind))
            if mod.bias is not None:
                mod.bias.zero_()


def relu(x):
    return torch.relu(x)


def leaky_relu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def tanh(x):
    return torch.tanh(x)
