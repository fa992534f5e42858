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
fixed-order kernel ``csrc/plane_stats.cu`` (``plane_mean_var``; torch's
CUDA mean splits its sum by the shape of the whole tensor), and the engine
gives every forward one batch shape
(``models.InferenceSession.batch_size``), so cuDNN, which picks its
algorithm by the shape of the call, keeps one. On the CPU every conv and
conv-transpose runs one sample at a time (``_per_sample``): oneDNN also
picks by shape.

``conv2d_s2d`` and ``conv_transpose2d_s2d`` of the JAX package are TPU
lowering tricks for a tiny output-channel count; their counterpart here is
the plain conv.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import roadmap
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
    --layout``)."""
    if x.device.type == 'cuda' and x.dtype != torch.float32:
        x = _channels_last_1x1(x)
    out = _per_sample(F.conv_transpose2d, x, weight, None, stride, padding,
                      output_padding)
    return out if bias is None else out + bias[None, :, None, None]


def pad2d(x, n, mode='zero'):
    if mode == 'zero':
        return F.pad(x, (n, n, n, n))
    if mode == 'reflect':
        return F.pad(x, (n, n, n, n), mode='reflect')
    raise roadmap.not_ported(f'padding [{mode}]', roadmap.FAMILIES)


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
    result): the JAX package's two-pass formula in float32, the mean, then
    the mean of (x - mean)^2."""
    d = x.float()
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
        plane_mean_var.relayouts += 1
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
    plane_mean_var.launches += 1
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
    mean, var = st[:, 0], st[:, 1]
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
