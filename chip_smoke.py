"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels from this checkout, checks each against its plain PyTorch version
at the shapes of the main path, then drives flagship DeepLIIF inference
(4 x resnet_9blocks + 5 x unet_512, ngf 64, 512^2 tiles, random weights from
a seed) end to end through the port's user entry points, at float32,
bfloat16, int8 (ResNet-trunk scope, per-chunk dynamic scales) and bfloat16
with the fused translator stages (``fuse_stages``, which end in the tail
kernel ``tail_s2d_fused``). The float32 trunk kernel (split TF32 on the
tensor cores) is held to the float32 tolerance beside two controls on the
same inputs: cuDNN's 1x TF32 conv must fail it, the plain 3x TF32 emulation
must pass it. Every path must give a
tile the same outputs alone as inside a batch of 16 (``batch_invariance``;
the engine runs every forward at its one batch shape of 16 tiles). The
bf16 trunk is held to accuracy against float32, beside two controls that
must come out either way (``bf16_chain_check``: an exactly rounded conv
passes, a conv rounded toward zero fails), on its 9-block chain, on one
translator and on the bf16 sessions' outputs (``session_vs_plain_trunk``).
The device quantifier (``device_quant``) is checked on synthetic seg canvases
of 1536x1280 (an ROI) and 8192x8192 (67.1 MPx) with its labeling kernel
against the plain labeling and against the host quantifier, and drives the
float32 main path once more with ``device_quant=True``.

    python3 chip_smoke.py            # needs one CUDA card; exits 0 on success

Prints one line per phase, then the kernel report as a JSON line, the card's
name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before that line. There is no CPU path.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
TILE, OVERLAP, BATCH = 512, 32, 16
# float32 kernel vs plain tolerances. y: the repo's f32 layer tolerance
# (1e-4 absolute). stats: max |delta| over the largest |stat| of its kind,
# 1e-4, because the two versions sum 16384 float32 terms per (sample,
# channel) in different orders and sum(y) cancels.
Y_TOL, STATS_TOL = 1e-4, 1e-4
# bfloat16 kernel vs plain: y within one bf16 ulp of the plain y (both
# round an f32 sum of the same exact products, taken in other orders);
# stats as for float32.
BF16_ULP = 2.0 ** -7
# int8 kernel vs plain: y bit-equal (the integer sums are exact and the
# rounding points fixed); stats within 1e-5 of the largest stat of their
# kind, because the float32 sums of the dequantized values run in another
# order (the plain version sums with torch's reductions).
INT8_STATS_TOL = 1e-5
# 9-block chains, kernel vs plain: max |delta| over the largest |y| and
# mean |delta| over mean |y|, at most 2**-3 and 2**-4 for int8. Each conv
# agrees (int8 bit-equal, checked above), but the float32 stats differ in
# the last bits, which can round a norm scale to the next bf16 value; in
# int8 that flips quantization steps, and one flipped value can move a
# chunk's max and so re-quantize the whole chunk. Through 18 norms the two
# chains drift apart to about int8's own noise (measured on these seeded
# inputs: int8 static max 0.021, mean 0.0072; int8 dynamic max 0.027,
# mean 0.017). A broken kernel moves every element by O(1).
CHAIN_TOL = {'int8': (2.0 ** -3, 2.0 ** -4)}
# bf16 9-block chains: max |delta| against the plain chain over its largest
# |y| at most 2**-5; and accuracy against float32 (the float32 chain on the
# same bf16 inputs and weights): mean |delta| from it over its mean |y| at
# most CHAIN_F32_MARGIN times the plain bf16 chain's. Closeness to the
# plain chain in mean admits only the plain version's summation order: a
# bf16 chain amplifies the one-ulp flips of any other order (about 3e-4 of
# the outputs of a conv) to a mean of about 0.008 from the plain chain,
# while its accuracy does not move. Mean |delta| from the float32 chain as
# a multiple of the plain chain's, zero / reflect pad: on the H100 (this
# script's inputs) a float64 conv rounded once (exact) x1.0003 / x0.9995,
# the plain conv rounded toward zero (a one-ulp bias, the smallest
# systematic fault) x1.070 / x1.069; on the CPU at (2, 32, 32, 256)
# (tests/test_torch_port_chain_bound.py) exact x1.002 / x0.999, toward
# zero x1.072 / x1.071, every nonzero output moved one ulp at random
# x1.81 / x1.83. Two controls run beside the kernel on the same inputs: the
# exact conv must pass and the round-toward-zero conv must fail, or the
# bound is not measuring accuracy.
BF16_CHAIN_MAX = 2.0 ** -5
CHAIN_F32_MARGIN = 1.02
# the fused stages against the unfused ones (both bf16, the same trunk
# kernel): two bf16 realizations of one function that differ by design
# (the fused stages take their norm statistics from the float32 conv
# accumulator, the unfused norms from the bf16-rounded conv output), so
# the bound is bf16's own noise (mean and max |delta| of the unfused
# translator against its float32 twin), and the fused translator may be no
# further from the float32 twin than the unfused one, up to 5 %. (On the
# CPU at full width, 128^2 tiles: fused vs unfused 0.55 of the noise mean,
# fused vs float32 0.01207 against 0.01210 for unfused.) A broken stage
# kernel moves every element by O(1).
FUSED_VS_F32_MARGIN = 1.05
# one full-width translator, kernel trunk vs plain trunk, on the tanh
# output: float32 within the layer tolerance (absolute). bf16/int8 relative
# to their own rounding noise, read from the same translator at float32
# (its twin): the kernel trunk may move the output by at most its max
# |delta| from the twin, and (int8) by at most half its mean |delta|
# (measured on this seed: int8 0 against 0.035 and 0.33). bf16 is held in
# mean by accuracy, as its chains are: the kernel-trunk translator no
# further from the twin than the plain-trunk translator, up to
# CHAIN_F32_MARGIN (the half-noise bound held a tensor-core trunk to the
# plain trunk's summation order, as the old chain bound did).
TRANSLATOR_TOL_F32 = 1e-4
TRANSLATOR_NOISE_SHARE = 0.5
# the bf16 sessions (bf16, and bf16 fused) on the 1024^2 image against the
# same session with the plain trunk swapped in, and with the exact control
# (exact_conv) as its trunk conv, each modality's uint8 output: the CPU
# tests' bf16 limit against JAX (PERF.md section 2) is mean |delta| <= 0.5
# LSB and >= 99 % of pixels within 2 LSB (SESSION_U8_*). Between two bf16
# sessions that differ only in the trunk conv's summation order that limit
# does not hold at the flagship's size: the exact control's session lands
# 0.48-0.55 LSB mean and 98.7-99.1 % within 2 LSB from the plain-trunk
# session, while every one of the three sessions is 1.35-1.48 LSB from
# the float32 session, equal to 4 digits (measured on the H100). So the
# phase reports that limit and holds the kernel-trunk session (K) to what a
# sound conv reaches, per modality: K no further from the plain-trunk
# session (P) than the exact control's (E) is, in mean |delta| up to
# SESSION_MARGIN and in the share within 2 LSB down to SESSION_SHARE_SLACK
# (closeness); and K no further from the float32 session (F) than P is, up
# to CHAIN_F32_MARGIN (accuracy). E must pass accuracy, and the round-
# toward-zero control's session must fail closeness: measured, it lands
# 0.81-0.91 LSB from P (E: 0.48-0.55), though only x1.006-1.009 of P's
# distance from F, so accuracy alone is blind at this level.
SESSION_U8_MEAN, SESSION_U8_WITHIN_2 = 0.5, 0.99
SESSION_MARGIN, SESSION_SHARE_SLACK = 1.05, 0.002
# ragged shapes for the tensor-core kernels of conv3x3_wgmma.cuh: H, W not
# multiples of their 16 x 16 tile (of output pixels; of input pixels for
# convtranspose3_s2_stats), channels multiples of 8 but not of their
# stage (16 bf16, 8 f32 channels) or their 128-channel block (64 for the
# conv-transpose and the f32 trunk): conv3x3_stats bf16 and f32 (C in, C
# out), conv3x3_s2_stats and convtranspose3_s2_stats ((x shape, Cout)); the
# same bounds as at the flagship shapes
RAGGED_TRUNK = ((2, 37, 45, 40), (1, 18, 130, 72))
# ragged shapes for the int8 trunk kernel: its contract admits H % 16 == 0
# or H < 16 (the dynamic scale's chunk) and C % 8 == 0; W and C not
# multiples of its 16-column tile, 32-channel stage or 64-channel block
RAGGED_INT8 = ((2, 32, 45, 40), (1, 16, 130, 72), (1, 12, 30, 24))
RAGGED_STAGES = {
    'conv3x3_s2_stats': (((2, 38, 46, 40), 56), ((2, 18, 130, 72), 24)),
    'convtranspose3_s2_stats': (((2, 37, 45, 40), 56), ((2, 19, 66, 72), 24))}
KERNEL_SHAPE = (4, 128, 128, 256)    # flagship trunk: (S, 512/4, 512/4, 4*64)
TIMING_SHAPE = (16, 128, 128, 256)   # the same at batch 16
LAUNCHES_PER_FORWARD = 4 * 9 * 2     # nets x blocks x convs
# the fused translator stages at batch 16: (call, kernel, x shape, Cout,
# input affine + ReLU); each kernel runs twice per translator
STAGE_CALLS = (
    ('down0', 'conv3x3_s2_stats', (BATCH, TILE, TILE, 64), 128, True),
    ('down1', 'conv3x3_s2_stats', (BATCH, TILE // 2, TILE // 2, 128), 256, True),
    ('up0', 'convtranspose3_s2_stats', (BATCH, TILE // 4, TILE // 4, 256), 128,
     False),
    ('up1', 'convtranspose3_s2_stats', (BATCH, TILE // 2, TILE // 2, 128), 64,
     True))
STAGE_LAUNCHES_PER_FORWARD = 4 * 2   # nets x calls of each stage kernel
# stage kernels vs plain: y within one bf16 ulp, stats within 1e-5 of the
# largest stat of their kind (float32 sums of up to 512^2 terms in
# different orders)
STAGE_STATS_TOL = 1e-5
# the translator tail (affine -> ReLU -> pad 3 -> 7x7 conv -> bias -> tanh)
# at batch 16: up1's output (S, 512, 512, ngf) -> 3 channels; one launch per
# translator on the fused path
TAIL_SHAPE, TAIL_COUT = (BATCH, TILE, TILE, 64), 3
TAIL_LAUNCHES_PER_FORWARD = 4
# tail kernel vs plain: the block form (the conv rounded to bf16) within one
# bf16 ulp (both round a float32 sum of the same exact products, taken in
# other orders); the fused form within one bf16 ulp of each of the three
# values it rounds, |c| + |c + b| + |y| (c the rounded conv, y the output):
# a conv one ulp apart moves the bf16 sum with the bias by up to that ulp,
# and tanh passes it on scaled by at most 1
# norm-statistics calls per batch forward (plane_mean_var, one per norm): a
# translator has 5 norms, a unet_512 15 (innermost up, 4 x (down, up), 3 x
# (down, up)); the fused stages take only the head's statistics, through
# plane_sums (one)
PLANE_PER_FORWARD = {False: 4 * 5 + 5 * 15, True: 4 + 5 * 15}
# plane_stats vs plain: sums of 512^2 float32 terms in different orders
PLANE_TOL = 1e-5
# the unet_512's up-norm planes (C, H, W), the outputs of its
# conv-transposes: 2^2 to 32^2 at 512 channels, then 64^2 x 256, 128^2 x
# 128, 256^2 x 64. The float32 path's reach the kernel in NCHW memory
# (cuDNN's float32 conv-transposes run NCHW), the other paths' in
# channels_last, where the small planes at 512 channels take the narrow
# geometry (fewer channel units a block)
UP_NORM_PLANES = tuple((512, 2 ** k, 2 ** k) for k in range(1, 6)) + (
    (256, 64, 64), (128, 128, 128), (64, 256, 256))
# published H100 SXM peaks at 700 W (dense): FP32 outside the tensor cores
# (FFMA), TF32, bf16 and int8 tensor cores; HBM3 bandwidth
PEAK_OPS = {'float32': 67e12, 'tf32': 495e12, 'bfloat16': 989e12,
            'int8': 1979e12}
PEAK_BYTES = 3.35e12
# the float32 trunk kernel runs on the TF32 tensor cores by split TF32: 3
# TF32 products per multiply-add, so its own bound is 3x the TF32 time
SPLIT_TF32_PRODUCTS = 3
ROUTE_PEAK = {'float32': PEAK_OPS['tf32'] / SPLIT_TF32_PRODUCTS,
              'bfloat16': PEAK_OPS['bfloat16'], 'int8': PEAK_OPS['int8']}
OUTPUTS = {'mod1-Hema', 'mod2-DAPI', 'mod3-Lap2', 'mod4-Marker', 'Seg',
           'SegOverlaid', 'SegRefined'}
# the device quantifier's synthetic seg canvases: the JAX ROI canvas and the
# largest canvas the JAX package measured (67.1 MPx); one nucleus per 40 x 40
# px grid cell and a sparser second layer give 48k cells at 67 MPx, past the
# 16384 that the KDE keeps
QUANT_CANVASES = ((1536, 1280), (8192, 8192))
CELL_GRID = 40
# labels launched per device-quantifier call: conn 4 on the unknown mask
# (background flood), conn 8 on the cell mask
LABEL_PER_QUANT = 2


def phase(name, **info):
    print(json.dumps({'phase': name, **info}, default=str), flush=True)


def fail(msg):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else \
        f'nvidia-smi failed: {res.stderr.strip()}'


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters):
    """Times each of ``fns`` ({name: fn}) in turns a, b, b, a (...), and
    returns ({name: [ms, ms]}, {name: mean ms})."""
    order = list(fns) + list(fns)[::-1]
    runs = {k: [] for k in fns}
    for k in order:
        runs[k].append(cuda_ms(fns[k], iters[k] if isinstance(iters, dict)
                               else iters))
    return runs, {k: sum(v) / len(v) for k, v in runs.items()}


def stats_rel(got, ref):
    return max(((got[:, q] - ref[:, q]).abs().max()
                / ref[:, q].abs().max()).item() for q in range(2))


def trunk_ops(shape):
    s, h, w, c = shape
    return 2.0 * s * h * w * c * c * 9


def bound(kind, shape, elem_bytes, w_bytes):
    """Least time (ms) for one trunk conv at ``shape``: ops over the peak
    of its route (float32: split TF32, ROUTE_PEAK), or bytes (x read once, w
    read once, y written once, the stats written once) over HBM bandwidth,
    whichever is larger."""
    s, h, w, c = shape
    nbytes = 2 * s * h * w * c * elem_bytes + 9 * c * c * w_bytes + s * 2 * c * 4
    t_ops, t_bytes = trunk_ops(shape) / ROUTE_PEAK[kind], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


class Rand:
    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.gen_cuda = torch.Generator(device='cuda').manual_seed(seed)

    def __call__(self, *shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(shape, generator=self.gen)).cuda()

    def big(self, *shape, dtype=torch.bfloat16):
        """N(0, 1) drawn on the card (activation-sized tensors)."""
        return torch.randn(shape, generator=self.gen_cuda,
                           device='cuda').to(dtype)

    def int8_weights(self, c):
        """Per-output-channel int8 quantization of an N(0, 0.02) HWIO conv."""
        from deepliif_tpu_torch.ops import quant
        return quant.quantize_conv_int8(self(3, 3, c, c, std=0.02))

    def blocks(self, c, n, dtype):
        def norm():
            return {'scale': self(c, std=0.02, mean=1.0),
                    'bias': self(c, std=0.01)}
        out = []
        for _ in range(n):
            b = {'norm1': norm(), 'norm2': norm()}
            for j in (1, 2):
                if dtype == 'int8':
                    b[f'w{j}q'], b[f'w{j}s'] = self.int8_weights(c)
                else:
                    b[f'w{j}'] = self(3, 3, c, c, std=0.02).to(dtype)
            out.append(b)
        return out


def chain_check(got, want, kind, **info):
    got, want = got.float(), want.float()
    d = (got - want).abs()
    rel = (d.max() / want.abs().max()).item()
    mean_rel = (d.mean() / want.abs().mean()).item()
    phase('resblock_chain_vs_plain', blocks=9, max_rel_err=rel,
          mean_rel_err=mean_rel, byte_equal=bool(torch.equal(got, want)),
          **info)
    check(rel <= CHAIN_TOL[kind][0] and mean_rel <= CHAIN_TOL[kind][1],
          f'{kind} chain error {rel} (mean {mean_rel})')


def trunk_conv_variant(FR, acc_dtype, to_bf16):
    """The plain bf16 trunk conv (``conv3x3_stats_reference``: affine and
    ReLU in bf16, pad) with its conv summed in ``acc_dtype`` and rounded to
    bf16 by ``to_bf16``; stats from the unrounded conv."""
    def conv(x, w, padding='reflect', in_scale=None, in_bias=None,
             in_relu=False):
        u = FR._transform(x, in_scale, in_bias, in_relu).permute(0, 3, 1, 2)
        u = torch.nn.functional.pad(u, (1, 1, 1, 1), mode='reflect'
                                    if padding == 'reflect' else 'constant')
        y = torch.nn.functional.conv2d(u.to(acc_dtype),
                                       w.to(acc_dtype).permute(3, 2, 0, 1))
        return (to_bf16(y).permute(0, 2, 3, 1).contiguous(),
                FR._stats(y.float()))
    return conv


def bf16_toward_zero(y):
    """float32 -> bfloat16 rounded toward zero (the low 16 bits cut)."""
    return (y.float().contiguous().view(torch.int32) & -65536).view(
        torch.float32).to(torch.bfloat16)


def exact_conv(FR):
    """The control that must pass the chain bound: the conv summed in
    float64 and rounded once, a sound conv in another summation order than
    the plain version's cuDNN float32 conv."""
    return trunk_conv_variant(FR, torch.float64,
                              lambda y: y.to(torch.bfloat16))


def biased_conv(FR):
    """The control that must fail the chain bound: the plain conv with its
    bf16 output rounded toward zero, a one-ulp bias, the smallest
    systematic fault a kernel could have."""
    return trunk_conv_variant(FR, torch.float32, bf16_toward_zero)


def chain_through(FR, conv, x, blocks, padding):
    """The resblock chain of ``blocks`` with ``conv`` as its trunk conv."""
    return FR._chain(lambda h, b, j, **kw: conv(h, b[f'w{j}'],
                                                padding=padding, **kw),
                     x, blocks, 1e-5)


def bf16_chain_accuracy(FR, x, blocks, padding, convs):
    """The bf16 chains of ``blocks`` (bf16 weights, float32 norms) on bf16
    ``x`` through the plain conv and through each of ``convs`` ({name:
    conv}), against the float32 chain on the same values: returns {name:
    mean |delta| from the float32 chain over its mean |y|} ('plain'
    included) and {name: max |delta| from the plain chain over its largest
    |y|}."""
    blocks32 = [{k: (v.float() if k.startswith('w') else v)
                 for k, v in b.items()} for b in blocks]
    f32 = FR.resblock_chain_reference(x.float(), blocks32, padding=padding)
    plain = FR.resblock_chain_reference(x, blocks, padding=padding).float()
    scale = f32.abs().mean()
    dist = {'plain': ((plain - f32).abs().mean() / scale).item()}
    vs_plain = {}
    for name, conv in convs.items():
        got = chain_through(FR, conv, x, blocks, padding).float()
        dist[name] = ((got - f32).abs().mean() / scale).item()
        vs_plain[name] = ((got - plain).abs().max()
                          / plain.abs().max()).item()
    return dist, vs_plain


def within_chain_bound(dist, name):
    """The bf16 chain accuracy bound: chain ``name`` no further from the
    float32 chain than the plain chain is, up to CHAIN_F32_MARGIN."""
    return dist[name] <= CHAIN_F32_MARGIN * dist['plain']


def bf16_chain_check(FR, x, blocks, padding):
    """The kernel's bf16 chain within the accuracy bound and within
    BF16_CHAIN_MAX of the plain chain; the exact control within the bound
    and the round-toward-zero control outside it."""
    dist, vs_plain = bf16_chain_accuracy(
        FR, x, blocks, padding, {'kernel': FR.conv3x3_stats,
                                 'exact': exact_conv(FR),
                                 'biased': biased_conv(FR)})
    ok = {name: within_chain_bound(dist, name) for name in vs_plain}
    phase('resblock_chain_vs_float32', kernel='conv3x3_stats bf16', blocks=9,
          padding=padding, mean_rel_vs_float32=dist,
          ratio_to_plain={k: v / dist['plain'] for k, v in dist.items()},
          within_bound=ok, margin=CHAIN_F32_MARGIN,
          max_rel_vs_plain=vs_plain, max_bound=BF16_CHAIN_MAX)
    check(ok['exact'], f'{padding}: the exact control fails the chain bound '
                       f'({dist}): the bound does not measure accuracy')
    check(not ok['biased'], f'{padding}: the round-toward-zero control '
                            f'passes the chain bound ({dist}): the bound '
                            'does not measure accuracy')
    check(ok['kernel'] and vs_plain['kernel'] <= BF16_CHAIN_MAX,
          f'{padding}: bf16 chain vs float32 {dist}, max vs plain '
          f'{vs_plain["kernel"]} > {BF16_CHAIN_MAX}')


def determinism(conv, x, kw, per_sample, what):
    """Two launches byte-equal; sample 1 alone byte-equal to sample 1 in
    the batch (``per_sample``: the per-sample keyword arguments). ``conv``
    returns a tensor or a tuple of tensors, each with the batch first."""
    def run(xx, **k):
        out = conv(xx, **k)
        return out if isinstance(out, tuple) else (out,)
    outs = run(x, **kw)
    check(all(torch.equal(a, b) for a, b in zip(outs, run(x, **kw))),
          f'{what}: two launches differ')
    kw1 = dict(kw, **{k: (v[1:2].contiguous() if v is not None else None)
                      for k, v in per_sample.items()})
    check(all(torch.equal(a[0], b[1])
              for a, b in zip(run(x[1:2].contiguous(), **kw1), outs)),
          f'{what}: sample alone differs from the sample in the batch')


def float64_conv(FR, x, w, padding='reflect', in_scale=None, in_bias=None,
                 in_relu=False):
    """The float32 trunk conv's y from a float64 conv: the affine and ReLU
    in float32 as the kernel and the plain version run them, then the conv
    of those values in float64 (the exact sum, up to float64's rounding)."""
    u = FR._transform(x, in_scale, in_bias, in_relu).permute(0, 3, 1, 2)
    u = torch.nn.functional.pad(u, (1, 1, 1, 1), mode='reflect'
                                if padding == 'reflect' else 'constant')
    y = torch.nn.functional.conv2d(u.double(),
                                   w.double().permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def tf32_control(FR, x, **kw):
    """The plain version with cuDNN's TF32 on (1x TF32: what a TF32 conv
    computes), TF32 restored afterwards."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return FR.conv3x3_stats_reference(x, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def trunk_f32_case(FR, x, wt, sc, bi, padding, affine, controls=False):
    """One conv3x3_stats float32 case: within Y_TOL and STATS_TOL of the
    plain version, byte-equal run to run and per sample; the kernel's and
    the plain version's max |dy| from a float64 conv beside each other.
    ``controls``: the 1x TF32 control must fail Y_TOL (else the check could
    not see TF32's error) and the 3x TF32 emulation must pass it. Returns
    max |dy|."""
    s = x.shape[0]
    kw = dict(w=wt, padding=padding, in_relu=affine,
              in_scale=sc[:s] if affine else None,
              in_bias=bi[:s] if affine else None)
    y, st = FR.conv3x3_stats(x, **kw)
    y_ref, st_ref = FR.conv3x3_stats_reference(x, **kw)
    y64 = float64_conv(FR, x, **kw)
    torch.cuda.synchronize()
    err = (y - y_ref).abs().max().item()
    rel = stats_rel(st, st_ref)
    info = dict(max_abs_err_y=err, stats_rel_err=rel,
                kernel_vs_float64=(y.double() - y64).abs().max().item(),
                plain_vs_float64=(y_ref.double() - y64).abs().max().item())
    if controls:
        y1 = tf32_control(FR, x, **kw)[0]
        y3 = FR.conv3x3_stats_split_tf32_reference(x, **kw)[0]
        torch.cuda.synchronize()
        info['tf32x1_control_err'] = (y1 - y_ref).abs().max().item()
        info['tf32x3_emulation_err'] = (y3 - y_ref).abs().max().item()
        info['tf32x3_emulation_vs_float64'] = (
            y3.double() - y64).abs().max().item()
    phase('kernel_vs_plain', kernel='conv3x3_stats f32', shape=list(x.shape),
          padding=padding, affine_relu=affine, **info)
    check(err < Y_TOL, f'f32 y error {err} >= {Y_TOL} at {tuple(x.shape)}')
    check(rel < STATS_TOL, f'f32 stats error {rel} >= {STATS_TOL}')
    if controls:
        check(info['tf32x1_control_err'] >= Y_TOL,
              f'the 1x TF32 control passes Y_TOL ({info}): the check cannot '
              'see TF32\'s error')
        check(info['tf32x3_emulation_err'] < Y_TOL,
              f'the 3x TF32 emulation fails Y_TOL ({info})')
    if s > 1:
        determinism(FR.conv3x3_stats, x, kw,
                    {'in_scale': kw['in_scale'], 'in_bias': kw['in_bias']},
                    'conv3x3_stats f32')
    return err


def kernel_checks_f32(FR, rnd):
    s, h, w, c = KERNEL_SHAPE
    x = rnd(*KERNEL_SHAPE)
    wt = rnd(3, 3, c, c, std=0.02)
    sc, bi = rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    worst = 0.0
    for padding in ('zero', 'reflect'):
        for affine in (False, True):
            worst = max(worst, trunk_f32_case(FR, x, wt, sc, bi, padding,
                                              affine, controls=True))
    phase('kernel_deterministic', kernel='conv3x3_stats f32',
          two_launches_byte_equal=True, batch_invariant=True)

    blocks = rnd.blocks(c, 9, torch.float32)
    for padding in ('zero', 'reflect'):
        got = FR.resblock_chain(x, blocks, padding=padding)
        want = FR.resblock_chain_reference(x, blocks, padding=padding)
        err = (got - want).abs().max().item()
        phase('resblock_chain_vs_plain', kernel='conv3x3_stats f32', blocks=9,
              padding=padding, max_abs_err=err)
        check(err < Y_TOL, f'9-block chain error {err} >= {Y_TOL}')

    # ragged shapes, from a generator of their own (the draws of the other
    # phases stay those of earlier runs)
    rr = Rand(SEED + 3)
    for shape in RAGGED_TRUNK:
        n, _, _, cr = shape
        xr = rr(*shape)
        wr = rr(3, 3, cr, cr, std=0.05)
        scr, bir = rr(n, cr, std=0.1, mean=1.0), rr(n, cr, std=0.1)
        for padding in ('zero', 'reflect'):
            for affine in (False, True):
                worst = max(worst, trunk_f32_case(FR, xr, wr, scr, bir,
                                                  padding, affine))
    return worst


def bf16_ulps(y, y_ref):
    """max |y - y_ref| in units of one bf16 ulp of |y_ref| (1e-6 absolute
    for outputs near zero), and the max |y - y_ref|."""
    d = (y.float() - y_ref.float()).abs()
    return ((d / (BF16_ULP * y_ref.float().abs() + 1e-6)).max().item(),
            d.max().item())


def trunk_bf16_case(FR, x, wt, sc, bi, padding, affine):
    """One conv3x3_stats bf16 case: within one ulp and STATS_TOL of the
    plain version, byte-equal run to run and per sample; returns max |dy|."""
    s = x.shape[0]
    kw = dict(w=wt, padding=padding, in_relu=affine,
              in_scale=sc[:s] if affine else None,
              in_bias=bi[:s] if affine else None)
    y, st = FR.conv3x3_stats(x, **kw)
    y_ref, st_ref = FR.conv3x3_stats_reference(x, **kw)
    torch.cuda.synchronize()
    ulps, err = bf16_ulps(y, y_ref)
    rel = stats_rel(st, st_ref)
    phase('kernel_vs_plain', kernel='conv3x3_stats bf16',
          shape=list(x.shape), padding=padding, affine_relu=affine,
          max_abs_err_y=err, y_bit_equal=bool(err == 0.0),
          max_err_in_ulps=ulps, stats_rel_err=rel)
    check(ulps <= 1.0, f'bf16 y off by {ulps} ulp at {tuple(x.shape)}')
    check(rel < STATS_TOL, f'bf16 stats error {rel} >= {STATS_TOL}')
    if s > 1:
        determinism(FR.conv3x3_stats, x, kw,
                    {'in_scale': kw['in_scale'], 'in_bias': kw['in_bias']},
                    'conv3x3_stats bf16')
    return err


def kernel_checks_bf16(FR, rnd):
    s, h, w, c = KERNEL_SHAPE
    x = rnd(*KERNEL_SHAPE).to(torch.bfloat16)
    wt = rnd(3, 3, c, c, std=0.02).to(torch.bfloat16)
    sc, bi = rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    worst = 0.0
    for padding in ('zero', 'reflect'):
        for affine in (False, True):
            worst = max(worst, trunk_bf16_case(FR, x, wt, sc, bi, padding,
                                               affine))
    phase('kernel_deterministic', kernel='conv3x3_stats bf16',
          two_launches_byte_equal=True, batch_invariant=True)

    blocks = rnd.blocks(c, 9, torch.bfloat16)
    for padding in ('zero', 'reflect'):
        bf16_chain_check(FR, x, blocks, padding)

    # ragged shapes, from a generator of their own, so that the draws of
    # the other phases stay those of earlier runs
    rr = Rand(SEED + 1)
    for shape in RAGGED_TRUNK:
        n, _, _, cr = shape
        xr = rr(*shape).to(torch.bfloat16)
        wr = rr(3, 3, cr, cr, std=0.05).to(torch.bfloat16)
        scr, bir = rr(n, cr, std=0.1, mean=1.0), rr(n, cr, std=0.1)
        for padding in ('zero', 'reflect'):
            for affine in (False, True):
                worst = max(worst, trunk_bf16_case(FR, xr, wr, scr, bir,
                                                   padding, affine))
    return worst


def trunk_int8_case(FR, x, wq, ws, inv_a, sc, bi, padding, affine,
                    dynamic):
    """One conv3x3_stats_int8 case: y bit-equal to the plain version, stats
    within INT8_STATS_TOL, byte-equal run to run and per sample; returns
    max |dy|."""
    s = x.shape[0]
    kw = dict(w_q=wq, deq=ws, inv_a=None if dynamic else inv_a,
              padding=padding, in_relu=affine, dynamic=dynamic,
              in_scale=sc[:s] if affine else None,
              in_bias=bi[:s] if affine else None)
    y, st = FR.conv3x3_stats_int8(x, **kw)
    y_ref, st_ref = FR.conv3x3_stats_int8_reference(x, **kw)
    torch.cuda.synchronize()
    rel = stats_rel(st, st_ref)
    err = (y.float() - y_ref.float()).abs().max().item()
    phase('kernel_vs_plain', kernel='conv3x3_stats_int8',
          mode='dynamic' if dynamic else 'static', shape=list(x.shape),
          padding=padding, affine_relu=affine,
          y_bit_equal=bool(torch.equal(y, y_ref)), max_abs_err_y=err,
          stats_rel_err=rel)
    check(torch.equal(y, y_ref),
          f'int8 y differs from the plain y at {tuple(x.shape)}')
    check(rel < INT8_STATS_TOL, f'int8 stats error {rel} >= {INT8_STATS_TOL}')
    if s > 1:
        determinism(FR.conv3x3_stats_int8, x, kw,
                    {'in_scale': kw['in_scale'], 'in_bias': kw['in_bias']},
                    'conv3x3_stats_int8')
    return err


def kernel_checks_int8(FR, rnd):
    s, h, w, c = KERNEL_SHAPE
    x = rnd(*KERNEL_SHAPE).to(torch.bfloat16)
    wq, ws = rnd.int8_weights(c)
    # static: a random positive per-input-channel 1/a_s
    inv_a = 127.0 / (2.0 + 2.0 * torch.rand(c, generator=rnd.gen)).cuda()
    sc, bi = rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    worst = 0.0
    for dynamic in (False, True):
        for padding in ('zero', 'reflect'):
            for affine in (False, True):
                worst = max(worst, trunk_int8_case(FR, x, wq, ws, inv_a, sc,
                                                   bi, padding, affine,
                                                   dynamic))
    phase('kernel_deterministic', kernel='conv3x3_stats_int8',
          two_launches_byte_equal=True, batch_invariant=True)

    # ragged shapes, from a generator of their own
    rr = Rand(SEED + 4)
    for shape in RAGGED_INT8:
        n, _, _, cr = shape
        xr = rr(*shape).to(torch.bfloat16)
        wqr, wsr = rr.int8_weights(cr)
        invr = 127.0 / (2.0 + 2.0 * torch.rand(cr, generator=rr.gen)).cuda()
        scr, bir = rr(n, cr, std=0.1, mean=1.0), rr(n, cr, std=0.1)
        for dynamic in (False, True):
            for padding in ('zero', 'reflect'):
                for affine in (False, True):
                    worst = max(worst, trunk_int8_case(
                        FR, xr, wqr, wsr, invr, scr, bir, padding, affine,
                        dynamic))

    # the dynamic scale per (sample, 16-row chunk) is exactly the chunk's
    # max |u|: an identity kernel (center tap = I, deq = 1) returns
    # round(+-127 * 127/m) * m/127 = +-m at the argmax. Each chunk of H =
    # 128 (8 chunks) gets its own spike, inside the chunk and larger than
    # its halo rows, so its window max is the spike.
    xi = rnd(s, h, w, c)
    spikes = torch.zeros(s, h // 16)
    for i in range(s):
        for r in range(h // 16):
            val = float(8 + i + 0.5 * r)      # bf16-exact, distinct
            xi[i, r * 16 + 5, (3 * r) % w, (7 * r) % c] = -val if r % 2 else val
            spikes[i, r] = val
    xi = xi.to(torch.bfloat16)
    eye = torch.zeros(3, 3, c, c, dtype=torch.int8, device=xi.device)
    eye[1, 1] = torch.eye(c, dtype=torch.int8, device=xi.device)
    yi, _ = FR.conv3x3_stats_int8(xi, eye, torch.ones(c, device=xi.device),
                                  padding='reflect', dynamic=True)
    xf = torch.nn.functional.pad(xi.float().permute(0, 3, 1, 2),
                                 (0, 0, 1, 1), mode='reflect')
    got = yi.float().abs().reshape(s, h // 16, 16, w, c).amax(dim=(2, 3, 4))
    host = torch.stack([xf[:, :, r * 16:r * 16 + 18].abs().amax(dim=(1, 2, 3))
                        for r in range(h // 16)], dim=1)
    phase('int8_dynamic_scale_exact', chunks=h // 16,
          kernel_m=got.flatten().tolist(), host_max=host.flatten().tolist())
    check(torch.equal(got.cpu(), host.cpu()) and torch.equal(host.cpu(), spikes),
          'dynamic scale per chunk is not the chunk window max')

    for dynamic in (False, True):
        blocks = rnd.blocks(c, 9, 'int8')
        for b in blocks:
            if not dynamic:
                b['a1'] = b['a2'] = 4.0 / 127.0
        for padding in ('zero', 'reflect'):
            chain_check(
                FR.resblock_chain_int8(x, blocks, padding=padding,
                                       dynamic=dynamic),
                FR.resblock_chain_int8_reference(x, blocks, padding=padding,
                                                 dynamic=dynamic),
                'int8', kernel='conv3x3_stats_int8', padding=padding,
                mode='dynamic' if dynamic else 'static')
    return worst


def kernel_timing(FR, rnd):
    """Each kernel against its plain version (and the library call where
    one computes the same function) at (16, 128, 128, 256), zero padding,
    with the norm affine and ReLU of a block's second conv, in turns."""
    import torch.nn.functional as F

    s, h, w, c = TIMING_SHAPE
    x32 = rnd(*TIMING_SHAPE)
    w32 = rnd(3, 3, c, c, std=0.02)
    sc, bi = rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    aff = dict(padding='zero', in_scale=sc, in_bias=bi, in_relu=True)
    out = {}
    for name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
        x, wt = x32.to(dt), w32.to(dt)
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
        wo = wt.permute(3, 2, 0, 1).contiguous()
        runs, ms = in_turns({
            'plain': lambda: FR.conv3x3_stats_reference(x, wt, **aff),
            'kernel': lambda: FR.conv3x3_stats(x, wt, **aff),
            'library': lambda: F.conv2d(xp, wo)}, 5)
        b_ms, _ = bound(name, TIMING_SHAPE, x.element_size(),
                        wt.element_size())
        # float32: the FP32 FFMA floor of a kernel on the CUDA cores
        floor = ({'ffma_floor_ms': trunk_ops(TIMING_SHAPE)
                  / PEAK_OPS['float32'] * 1e3} if name == 'float32' else {})
        out[name] = ms
        phase('kernel_timing', kernel=f'conv3x3_stats {name}',
              shape=list(TIMING_SHAPE), runs_ms=runs,
              **{f'{k}_ms': v for k, v in ms.items()},
              tflops=trunk_ops(TIMING_SHAPE) / ms['kernel'] / 1e9,
              bound_ms=b_ms, bound_share=b_ms / ms['kernel'], **floor,
              library_call='F.conv2d on the padded input (cuDNN, TF32 off)')
    xb = x32.to(torch.bfloat16)
    wq, ws = rnd.int8_weights(c)
    runs, ms = in_turns({
        'plain': lambda: FR.conv3x3_stats_int8_reference(
            xb, wq, ws, dynamic=True, **aff),
        'kernel': lambda: FR.conv3x3_stats_int8(xb, wq, ws, dynamic=True,
                                                **aff)},
        {'plain': 2, 'kernel': 5})
    ms_static = cuda_ms(lambda: FR.conv3x3_stats_int8(
        xb, wq, ws, torch.ones(c, device=xb.device), **aff), 5)
    out['int8'] = dict(ms, library=None, static=ms_static)
    b_ms, _ = bound('int8', TIMING_SHAPE, 2, 1)
    phase('kernel_timing', kernel='conv3x3_stats_int8', mode='dynamic',
          shape=list(TIMING_SHAPE), runs_ms=runs,
          **{f'{k}_ms': v for k, v in ms.items()},
          kernel_static_ms=ms_static, bound_ms=b_ms,
          bound_share=b_ms / ms['kernel'],
          what='the whole call: max pass (dynamic), quantize pass, weight '
               'pack, conv, stats reduction',
          library_call='none: no single PyTorch call computes an int8 conv')
    return out


def stage_bound(kernel, shape, cout):
    """(ms for the operations, ms for the bytes) of one stage call: 9 bf16
    MACs per (input pixel, cin, cout) for the conv-transpose (its 4 output
    phases take 1 + 2 + 2 + 4 taps), per (output pixel, cin, cout) for the
    stride-2 conv, over the bf16 peak; x and y once, w once, the stats once
    over HBM. The call's bound is the larger."""
    s, h, w, cin = shape
    ho, wo = (h // 2, w // 2) if kernel == 'conv3x3_s2_stats' else (h, w)
    ops = 2.0 * s * ho * wo * cin * cout * 9
    out_px = s * h * w * (4 if kernel == 'convtranspose3_s2_stats' else 0.25)
    nbytes = 2 * (s * h * w * cin + out_px * cout + 9 * cin * cout) \
        + s * 2 * cout * 4
    return ops / PEAK_OPS['bfloat16'] * 1e3, nbytes / PEAK_BYTES * 1e3


def kernel_checks_stages(FS, FR, rnd):
    """The two stage kernels at the four flagship calls of a batch-16
    forward: against the plain version, run to run and per sample, then
    timed in turns against the plain version and the library call (cuDNN
    bf16 on the affined input, no stats). Returns {kernel: sums over its
    two calls: their bounds, and the limit that weighs more in them}."""
    import torch.nn.functional as F
    from deepliif_tpu_torch.utils.checkpoints import weight_from_hwio

    library = {'conv3x3_s2_stats': lambda u, w: F.conv2d(
                   u, weight_from_hwio(w, 'conv'), stride=2, padding=1),
               'convtranspose3_s2_stats': lambda u, w: F.conv_transpose2d(
                   u, weight_from_hwio(w, 'convT'), stride=2, padding=1,
                   output_padding=1)}
    out = {}
    # the ragged shapes first, from a generator of their own (the draws of
    # conv3x3_s2_stats's are those of earlier runs)
    rr = Rand(SEED + 2)
    ragged_err = {}
    for name, cases in RAGGED_STAGES.items():
        kernel = getattr(FS, name)
        for shape, cout in cases:
            for affine in (False, True):
                s, _, _, cin = shape
                x = rr(*shape).to(torch.bfloat16)
                wt = rr(3, 3, cin, cout, std=0.05).to(torch.bfloat16)
                kw = dict(in_scale=rr(s, cin, std=0.1, mean=1.0),
                          in_bias=rr(s, cin, std=0.1),
                          in_relu=True) if affine else {}
                y, st = kernel(x, wt, **kw)
                y_ref, st_ref = getattr(FS, f'{name}_reference')(x, wt, **kw)
                torch.cuda.synchronize()
                ulps, err = bf16_ulps(y, y_ref)
                rel = stats_rel(st, st_ref)
                ragged_err[name] = max(ragged_err.get(name, 0.0), err)
                phase('kernel_vs_plain', kernel=name, call='ragged',
                      shape=list(shape), cout=cout, affine_relu=affine,
                      max_abs_err_y=err, y_bit_equal=bool(err == 0.0),
                      max_err_in_ulps=ulps, stats_rel_err=rel)
                check(ulps <= 1.0, f'{name} {tuple(shape)}: y off by {ulps} '
                      'ulp')
                check(rel < STAGE_STATS_TOL, f'{name} {tuple(shape)}: stats '
                      f'error {rel} >= {STAGE_STATS_TOL}')
                determinism(lambda xx, k_=kernel, w_=wt, **k: k_(xx, w_, **k),
                            x, kw,
                            {k: v for k, v in kw.items() if k != 'in_relu'},
                            f'{name} ragged')
    for call, name, shape, cout, affine in STAGE_CALLS:
        s, _, _, cin = shape
        x = rnd.big(*shape)
        wt = rnd(3, 3, cin, cout, std=0.02).to(torch.bfloat16)
        kw = dict(in_scale=rnd(s, cin, std=0.1, mean=1.0),
                  in_bias=rnd(s, cin, std=0.1), in_relu=True) if affine else {}
        kernel = getattr(FS, name)
        plain = getattr(FS, f'{name}_reference')
        y, st = kernel(x, wt, **kw)
        y_ref, st_ref = plain(x, wt, **kw)
        torch.cuda.synchronize()
        d = (y.float() - y_ref.float()).abs()
        err = d.max().item()
        ulps = (d / (BF16_ULP * y_ref.float().abs() + 1e-6)).max().item()
        rel = stats_rel(st, st_ref)
        phase('kernel_vs_plain', kernel=name, call=call, shape=list(shape),
              cout=cout, affine_relu=affine, max_abs_err_y=err,
              y_bit_equal=bool(err == 0.0), max_err_in_ulps=ulps,
              stats_rel_err=rel)
        check(ulps <= 1.0, f'{name} {call}: y off by {ulps} ulp')
        check(rel < STAGE_STATS_TOL,
              f'{name} {call}: stats error {rel} >= {STAGE_STATS_TOL}')
        determinism(lambda xx, **k: kernel(xx, wt, **k), x, kw,
                    {k: v for k, v in kw.items() if k != 'in_relu'},
                    f'{name} {call}')
        phase('kernel_deterministic', kernel=name, call=call,
              two_launches_byte_equal=True, batch_invariant=True)
        del y, st, y_ref, st_ref, d

        u = FR._transform(x, kw.get('in_scale'), kw.get('in_bias'),
                          affine).permute(0, 3, 1, 2)
        runs, ms = in_turns({'plain': lambda: plain(x, wt, **kw),
                             'kernel': lambda: kernel(x, wt, **kw),
                             'library': lambda: library[name](u, wt)}, 3)
        t_ops, t_bytes = stage_bound(name, shape, cout)
        phase('kernel_timing', kernel=name, call=call, shape=list(shape),
              cout=cout, runs_ms=runs, **{f'{k}_ms': v for k, v in ms.items()},
              tflops=t_ops * PEAK_OPS['bfloat16'] / ms['kernel'] / 1e12,
              bound_ms=max(t_ops, t_bytes),
              bound_share=max(t_ops, t_bytes) / ms['kernel'],
              bound_by='operations' if t_ops >= t_bytes else 'bytes',
              library_call=('F.conv2d' if name == 'conv3x3_s2_stats' else
                            'F.conv_transpose2d')
              + ' (cuDNN bf16) on the affined input, no stats')
        tot = out.setdefault(name, dict(calls=[], err=0.0, ms=0.0,
                                        plain_ms=0.0, library_ms=0.0,
                                        bound_ms=0.0, t_ops=0.0, t_bytes=0.0,
                                        per_call=[]))
        tot['calls'].append(call)
        tot['per_call'].append({
            'call': call, 'ms': ms['kernel'], 'library_ms': ms['library'],
            'bound_ms': max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes'})
        tot['err'] = max(tot['err'], err, ragged_err[name])
        tot['ms'] += ms['kernel']
        tot['plain_ms'] += ms['plain']
        tot['library_ms'] += ms['library']
        tot['bound_ms'] += max(t_ops, t_bytes)
        tot['t_ops'] += t_ops
        tot['t_bytes'] += t_bytes
        tot['bound_by'] = ('operations' if tot['t_ops'] >= tot['t_bytes']
                           else 'bytes')
        del x, u
        torch.cuda.empty_cache()
    return out


def tail_bound(shape, cout):
    """(ms for the operations over the bf16 tensor-core peak, ms for the
    bytes, ms for the operations over the FP32 FFMA peak) of one tail call:
    49 MACs per (output pixel, cin, cout); x and y once, w, b and the
    affine once over HBM. The call's bound is the larger of the first two;
    the third is the floor of a kernel on the CUDA cores."""
    s, h, w, cin = shape
    ops = 2.0 * s * h * w * cin * cout * 49
    nbytes = 2 * (s * h * w * (cin + cout) + 49 * cin * cout + cout) \
        + s * cin * 2 * 4
    return (ops / PEAK_OPS['bfloat16'] * 1e3, nbytes / PEAK_BYTES * 1e3,
            ops / PEAK_OPS['float32'] * 1e3)


def kernel_checks_tail(FS, FR, rnd):
    """The tail kernel at the flagship call of a batch-16 forward (up1's
    output, 64 channels -> 3, with up1's norm affine and ReLU), both
    paddings: the fused and the block form against their plain versions,
    run to run and per sample, refusals of what it does not take, then
    timed in turns against the plain version and the library call (cuDNN
    bf16 conv with bias, then tanh, on the affined and padded input, as the
    fused path ran its tail before the kernel). Returns {padding: numbers}."""
    import torch.nn.functional as F
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.utils.checkpoints import weight_from_hwio

    s, _, _, cin = TAIL_SHAPE
    wt = rnd(7, 7, cin, TAIL_COUT, std=0.02).to(torch.bfloat16)
    b = rnd(TAIL_COUT, std=0.1).to(torch.bfloat16)
    out = {}
    for padding in ('zero', 'reflect'):
        x = rnd.big(*TAIL_SHAPE)
        kw = dict(in_scale=rnd(s, cin, std=0.1, mean=1.0),
                  in_bias=rnd(s, cin, std=0.1), in_relu=True, padding=padding)
        y = FS.tail_s2d_fused(x, wt, b, **kw)
        y_ref = FS.tail_s2d_fused_reference(x, wt, b, **kw)
        c = FS._tail_conv(x, wt, kw['in_scale'], kw['in_bias'], True,
                          padding).to(torch.bfloat16).float()
        sb = (c + b.float()[None, :, None, None]).to(torch.bfloat16).float()
        torch.cuda.synchronize()
        d = (y.float() - y_ref.float()).abs()
        err = d.max().item()
        ulps = (d / (BF16_ULP * (c.abs() + sb.abs() + y_ref.float().abs())
                     + 1e-6)).max().item()
        del y, y_ref, c, sb, d
        yb = FS.tail_s2d_block(x, wt, **kw)
        yb_ref = FS.tail_s2d_block_reference(x, wt, **kw)
        torch.cuda.synchronize()
        db = (yb.float() - yb_ref.float()).abs()
        block_ulps = (db / (BF16_ULP * yb_ref.float().abs()
                            + 1e-6)).max().item()
        phase('kernel_vs_plain', kernel='tail_s2d', shape=list(TAIL_SHAPE),
              cout=TAIL_COUT, padding=padding, affine_relu=True,
              max_abs_err_y=err, y_bit_equal=bool(err == 0.0),
              max_err_in_ulps=ulps, block_max_abs_err=db.max().item(),
              block_max_err_in_ulps=block_ulps)
        check(ulps <= 1.0, f'tail_s2d_fused {padding}: y off by {ulps} of '
                           'its bound')
        check(block_ulps <= 1.0, f'tail_s2d_block {padding}: off by '
                                 f'{block_ulps} ulp')
        del yb, yb_ref, db
        per_sample = {'in_scale': kw['in_scale'], 'in_bias': kw['in_bias']}
        determinism(lambda xx, **k: FS.tail_s2d_fused(xx, wt, b, **k), x, kw,
                    per_sample, f'tail_s2d_fused {padding}')
        determinism(lambda xx, **k: FS.tail_s2d_block(xx, wt, **k), x, kw,
                    per_sample, f'tail_s2d_block {padding}')
        phase('kernel_deterministic', kernel='tail_s2d', padding=padding,
              forms=['fused', 'block'], two_launches_byte_equal=True,
              batch_invariant=True)
        refused = {}
        for what, bad in (('float32', x[:2].float()),
                          ('not contiguous', x[:2].transpose(1, 2))):
            try:
                FS.tail_s2d_fused(bad, wt, b, **dict(kw, **{
                    k: v[:2].contiguous() for k, v in per_sample.items()}))
                refused[what] = False
            except TypeError:
                refused[what] = True
        phase('kernel_refuses', kernel='tail_s2d', raised=refused)
        check(all(refused.values()), f'tail_s2d_fused ran on {refused}')

        u = FR._transform(x, kw['in_scale'], kw['in_bias'], True)
        up = L.pad2d(u.permute(0, 3, 1, 2), 3, padding)
        del u
        wo = weight_from_hwio(wt, 'conv')
        runs, ms = in_turns({
            'plain': lambda: FS.tail_s2d_fused_reference(x, wt, b, **kw),
            'kernel': lambda: FS.tail_s2d_fused(x, wt, b, **kw),
            'library': lambda: torch.tanh(F.conv2d(up, wo, b))},
            {'plain': 3, 'kernel': 20, 'library': 5})
        t_ops, t_bytes, t_ffma = tail_bound(TAIL_SHAPE, TAIL_COUT)
        out[padding] = dict(err=err, ms=ms['kernel'], plain_ms=ms['plain'],
                            library_ms=ms['library'],
                            bound_ms=max(t_ops, t_bytes),
                            bound_by='operations' if t_ops >= t_bytes
                            else 'bytes')
        phase('kernel_timing', kernel='tail_s2d', shape=list(TAIL_SHAPE),
              cout=TAIL_COUT, padding=padding, runs_ms=runs,
              **{f'{k}_ms': v for k, v in ms.items()},
              bound_ms=out[padding]['bound_ms'],
              bound_by=out[padding]['bound_by'],
              bound_share=out[padding]['bound_ms'] / ms['kernel'],
              ffma_floor_ms=t_ffma,
              library_call='torch.tanh(F.conv2d(..., bias)) (cuDNN bf16) on '
                           'the affined and padded input')
        del x, up
        torch.cuda.empty_cache()
    return out


def kernel_checks_plane(L, rnd):
    """The norm statistics (``plane_mean_var``: one call per norm, x read
    once) at the head conv output of a batch-16 forward, float32 and
    bfloat16, channels_last: against the plain two-pass version, also on an
    input with a large offset (mean 100, std 1, where sum x^2 - n mean^2
    would lose digits), run to run and per sample; ``plane_sums`` (the
    fused head's sums, derived from one ``plane_mean_var`` call) against
    plain sums; one call timed in turns against the plain version and
    torch.var_mean. Then every up-norm plane of a unet_512
    (``plane_checks_up_norms``). Returns {dtype name: numbers, 'up_norms':
    numbers}."""
    shape = (BATCH, 64, TILE, TILE)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace('torch.', '')
        x = rnd.big(BATCH, TILE, TILE, 64, dtype=dt).permute(0, 3, 1, 2)
        x = x + 0.5                         # a mean that is not zero
        x = x.contiguous(memory_format=torch.channels_last)
        far = (rnd.big(BATCH, TILE, TILE, 64, dtype=torch.float32) + 100.0
               ).to(dt).permute(0, 3, 1, 2)
        errs = {}
        for what, xx, fn, ref_fn in (
                ('mean_var', x, L.plane_mean_var, L.plane_mean_var_reference),
                ('mean_var_offset_100', far, L.plane_mean_var,
                 L.plane_mean_var_reference),
                ('sums', x, L.plane_sums, plain_sums)):
            got, ref = fn(xx), ref_fn(xx)
            torch.cuda.synchronize()
            errs[what] = dict(
                max_abs_err=[(got[:, q] - ref[:, q]).abs().max().item()
                             for q in range(2)],
                rel_err=stats_rel(got, ref))
            del got, ref
        del far
        phase('kernel_vs_plain', kernel='plane_stats', dtype=name,
              shape=list(shape), **errs)
        rel = max(e['rel_err'] for e in errs.values())
        check(rel < PLANE_TOL, f'plane_stats {name}: error {rel} >= '
                               f'{PLANE_TOL}')
        got = L.plane_mean_var(x)
        again = L.plane_mean_var(x)
        alone = L.plane_mean_var(x[1:2])
        check(torch.equal(got, again) and torch.equal(alone[0], got[1]),
              'plane_stats: not byte-equal run to run or alone vs in batch')
        phase('kernel_deterministic', kernel='plane_stats', dtype=name,
              two_launches_byte_equal=True, batch_invariant=True)
        runs, ms = in_turns({
            'plain': lambda: L.plane_mean_var_reference(x),
            'kernel': lambda: L.plane_mean_var(x),
            'library': lambda: torch.var_mean(x, dim=(2, 3), correction=0)},
            {'plain': 3, 'kernel': 20, 'library': 20})
        bound_ms = x.numel() * x.element_size() / PEAK_BYTES * 1e3
        phase('kernel_timing', kernel='plane_stats', dtype=name,
              shape=list(shape), runs_ms=runs,
              **{f'{k}_ms': v for k, v in ms.items()}, bound_ms=bound_ms,
              bound_by='bytes', bound_share=bound_ms / ms['kernel'],
              kernel_over_library=ms['kernel'] / ms['library'],
              what='one norm: one plane_mean_var call (x read once)',
              library_call='torch.var_mean over (H, W), correction=0')
        # the error of [mean, var], the function a norm calls
        err = max(max(errs[k]['max_abs_err'])
                  for k in ('mean_var', 'mean_var_offset_100'))
        out[name] = dict(err=err, ms=ms['kernel'], plain_ms=ms['plain'],
                         library_ms=ms['library'], bound_ms=bound_ms)
        del x
        torch.cuda.empty_cache()
    out['up_norms'] = plane_checks_up_norms(L, rnd)
    return out


def plain_sums(x):
    """[sum of x, sum of x^2] over (H, W) in float32, the fused head's
    statistics computed plainly."""
    d = x.float()
    return torch.stack([d.sum(dim=(2, 3)), (d * d).sum(dim=(2, 3))], dim=1)


def plane_checks_up_norms(L, rnd):
    """The statistics kernel at every up-norm plane of a unet_512 at batch
    16 (``UP_NORM_PLANES``), as the main path feeds it: float32 in NCHW
    memory (its chunk kernel for planes), bfloat16 in channels_last (down to
    one channel unit a block at 2^2 x 512). Each against the plain version,
    also at a mean of 100, read in place (no copy counted), run to run and
    alone vs in the batch; the largest NCHW plane timed in turns against
    the plain version and torch.var_mean. Returns the numbers."""
    worst, cases = 0.0, []
    for dt, nchw in ((torch.float32, True), (torch.bfloat16, False)):
        for c, h, w in UP_NORM_PLANES:
            for offset in (0.5, 100.0):
                if nchw:
                    x = (rnd.big(BATCH, c, h, w, dtype=torch.float32)
                         + offset).to(dt)
                else:
                    x = (rnd.big(BATCH, h, w, c, dtype=torch.float32)
                         + offset).to(dt).permute(0, 3, 1, 2)
                copies = L.plane_mean_var.relayouts
                got = L.plane_mean_var(x)
                ref = L.plane_mean_var_reference(x)
                again = L.plane_mean_var(x)
                alone = L.plane_mean_var(x[1:2])
                torch.cuda.synchronize()
                rel = stats_rel(got, ref)
                err = max((got[:, q] - ref[:, q]).abs().max().item()
                          for q in range(2))
                tag = (f'{str(dt).replace("torch.", "")} '
                       f'{"nchw" if nchw else "channels_last"} '
                       f'({BATCH}, {c}, {h}, {w}) + {offset}')
                check(L.plane_mean_var.relayouts == copies,
                      f'plane_stats {tag}: input copied, not read in place')
                check(rel < PLANE_TOL,
                      f'plane_stats {tag}: error {rel} >= {PLANE_TOL}')
                check(torch.equal(got, again) and torch.equal(alone[0],
                                                              got[1]),
                      f'plane_stats {tag}: not byte-equal run to run or '
                      'alone vs in batch')
                cases.append({'case': tag, 'rel_err': rel,
                              'max_abs_err': err})
                worst = max(worst, err)
                del x, got, ref, again, alone
    phase('kernel_vs_plain', kernel='plane_stats', what='up-norm planes',
          cases=cases, two_launches_byte_equal=True, batch_invariant=True,
          copies=0)
    c, h, w = max(UP_NORM_PLANES, key=lambda t: t[0] * t[1] * t[2])
    x = rnd.big(BATCH, c, h, w, dtype=torch.float32) + 0.5
    runs, ms = in_turns({
        'plain': lambda: L.plane_mean_var_reference(x),
        'kernel': lambda: L.plane_mean_var(x),
        'library': lambda: torch.var_mean(x, dim=(2, 3), correction=0)},
        {'plain': 3, 'kernel': 20, 'library': 20})
    bound_ms = x.numel() * x.element_size() / PEAK_BYTES * 1e3
    shape = [BATCH, c, h, w]
    phase('kernel_timing', kernel='plane_stats', dtype='float32',
          layout='nchw', shape=shape, runs_ms=runs,
          **{f'{k}_ms': v for k, v in ms.items()}, bound_ms=bound_ms,
          bound_by='bytes', bound_share=bound_ms / ms['kernel'],
          kernel_over_library=ms['kernel'] / ms['library'],
          what='the largest float32 up-norm, NCHW memory read in place',
          library_call='torch.var_mean over (H, W), correction=0')
    del x
    torch.cuda.empty_cache()
    return dict(err=worst, cases=len(cases), nchw_float32=dict(
        shape=shape, ms=ms['kernel'], plain_ms=ms['plain'],
        library_ms=ms['library'], bound_ms=bound_ms))


def write_flagship_model_dir(md, dl, ck):
    """DeepLIIFDef() defaults in the native npz layout, weights at the
    reference init (conv ~ N(0, 0.02), norm scale ~ N(1, 0.02), biases 0)
    drawn from a numpy seed."""
    d = dl.DeepLIIFDef()
    ens = dl.DeepLIIFNets(d)
    rng = np.random.default_rng(SEED)
    for group, nets_ in (('G', ens.G), ('GS', ens.GS)):
        flat = ck.flatten_tree(ck.params_to_jax(nets_[0]))
        out = {}
        for k, v in flat.items():
            shape = (len(nets_),) + v.shape
            if k.endswith('/w'):
                out[k] = rng.normal(0, 0.02, shape).astype(np.float32)
            elif k.endswith('/scale'):
                out[k] = (1 + 0.02 * rng.normal(0, 1, shape)).astype(np.float32)
            else:
                out[k] = np.zeros(shape, np.float32)
        np.savez(os.path.join(md, f'latest_net_{group}.npz'), **out)
    cfg = {'model': 'DeepLIIF', 'modalities_no': 4, 'netG': 'resnet_9blocks',
           'net_gs': 'unet_512', 'ngf': 64, 'norm': 'batch', 'padding': 'zero',
           'upsample': 'convtranspose', 'scale_size': TILE,
           'modalities_names': ['IHC', 'Hema', 'DAPI', 'Lap2', 'Marker'],
           'seg_weights': list(d.seg_weights), 'precision': 'float32'}
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump(cfg, f)


def ihc_like_image(size, seed):
    """Light background with hematoxylin-blue and DAB-brown nuclei."""
    rng = np.random.default_rng(seed)
    img = np.empty((size, size, 3), np.float32)
    img[:] = (222, 216, 210)
    img += rng.normal(0, 6, img.shape)
    yy, xx = np.mgrid[:size, :size]
    for _ in range(size * size // 1500):
        cy, cx = rng.integers(0, size, 2)
        r = rng.uniform(4, 9)
        color = (95, 85, 160) if rng.random() < 0.6 else (150, 95, 55)
        sl = (slice(max(cy - 10, 0), cy + 10), slice(max(cx - 10, 0), cx + 10))
        m = (yy[sl] - cy) ** 2 + (xx[sl] - cx) ** 2 < r * r
        img[sl][m] = color + rng.normal(0, 8, (m.sum(), 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def launch_counts(K):
    FR, FS, L, LB = K
    return {'float32': FR.conv3x3_stats.launches,
            'bfloat16': FR.conv3x3_stats.launches_bf16,
            'int8': FR.conv3x3_stats_int8.launches,
            'conv3x3_s2_stats': FS.conv3x3_s2_stats.launches,
            'convtranspose3_s2_stats': FS.convtranspose3_s2_stats.launches,
            'tail_s2d': (FS.tail_s2d_fused.launches
                         + FS.tail_s2d_block.launches),
            'plane_stats': L.plane_mean_var.launches,
            # norm inputs in neither channels_last nor NCHW memory, which
            # the wrapper copies before the kernel reads them
            'plane_relayouts': L.plane_mean_var.relayouts,
            'label_components': LB.label_components.launches}


def reset_counts(K):
    FR, FS, L, LB = K
    FR.conv3x3_stats.launches = 0
    FR.conv3x3_stats.launches_bf16 = 0
    FR.conv3x3_stats_int8.launches = 0
    FS.conv3x3_s2_stats.launches = 0
    FS.convtranspose3_s2_stats.launches = 0
    FS.tail_s2d_fused.launches = 0
    FS.tail_s2d_block.launches = 0
    L.plane_mean_var.launches = L.plane_mean_var.relayouts = 0
    LB.label_components.launches = 0


def expected_counts(precision, fused, n_forwards, quant_calls=0):
    """Launches of each kernel per main-path run: the trunk kernel of the
    precision, the stage and tail kernels on the fused path only, the
    statistics kernel once per norm (no norm input copied first), the
    labeling kernel twice per device-quantifier call."""
    want = {kind: 0 for kind in ('float32', 'bfloat16', 'int8')}
    want[precision] = LAUNCHES_PER_FORWARD
    for name in ('conv3x3_s2_stats', 'convtranspose3_s2_stats'):
        want[name] = STAGE_LAUNCHES_PER_FORWARD if fused else 0
    want['tail_s2d'] = TAIL_LAUNCHES_PER_FORWARD if fused else 0
    want['plane_stats'] = PLANE_PER_FORWARD[fused]
    want['plane_relayouts'] = 0
    want = {k: v * n_forwards for k, v in want.items()}
    want['label_components'] = LABEL_PER_QUANT * quant_calls
    return want


def throughput(session, batch, iters=3):
    session.run_tiles(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        session.run_tiles(batch)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return {'batch': len(batch), 'tiles_per_s': len(batch) * iters / seconds,
            'seconds_per_batch': seconds / iters, 'peak_mem_bytes': peak,
            'peak_mem_gib': peak / 2 ** 30}


@contextlib.contextmanager
def net_attrs(net, **attrs):
    """``net`` with ``attrs`` set for the duration of the block."""
    saved = {k: getattr(net, k) for k in attrs}
    for k, v in attrs.items():
        setattr(net, k, v)
    try:
        yield net
    finally:
        for k, v in saved.items():
            setattr(net, k, v)


@contextlib.contextmanager
def trunk_conv(FR, conv):
    """The trunk's conv (``FR.conv3x3_stats``, which the nets reach through
    ``FR.resblock_chain``) swapped for ``conv`` for the duration of the
    block."""
    kernel = FR.conv3x3_stats
    FR.conv3x3_stats = conv
    try:
        yield
    finally:
        FR.conv3x3_stats = kernel


def u8_distance(a, b):
    """{modality: (mean |a - b|, share of pixels within 2 LSB)} of two
    ``infer_modalities`` image dicts."""
    out = {}
    for k in sorted(a):
        if k.startswith('mod'):
            d = np.abs(np.asarray(a[k]).astype(np.int16)
                       - np.asarray(b[k]).astype(np.int16))
            out[k] = (float(d.mean()), float((d <= 2).mean()))
    return out


def session_vs_plain_trunk(M, FR, md, img, images, f32_images, kw, path):
    """The bf16 session's modalities for ``img`` (``images``, the main
    path's: K) against the same session with the plain trunk (P) and with
    the exact control's trunk (E), and against the float32 session
    (``f32_images``: F); see SESSION_MARGIN."""
    runs = {}
    for name, conv in (('plain', FR.conv3x3_stats_reference),
                       ('exact', exact_conv(FR)), ('biased', biased_conv(FR))):
        with trunk_conv(FR, conv):
            runs[name] = M.infer_modalities(img, TILE, md, device_quant=False,
                                            **kw)[0]
    k_p, e_p = u8_distance(images, runs['plain']), u8_distance(runs['exact'],
                                                                runs['plain'])
    k_f, p_f = u8_distance(images, f32_images), u8_distance(runs['plain'],
                                                             f32_images)
    e_f = u8_distance(runs['exact'], f32_images)
    b_p = u8_distance(runs['biased'], runs['plain'])
    b_f = u8_distance(runs['biased'], f32_images)
    issue_limit = {k: v[0] <= SESSION_U8_MEAN and v[1] >= SESSION_U8_WITHIN_2
                   for k, v in k_p.items()}
    def close(x_p, k):
        return (x_p[k][0] <= SESSION_MARGIN * e_p[k][0]
                and x_p[k][1] >= e_p[k][1] - SESSION_SHARE_SLACK)
    ok = {k: close(k_p, k) and k_f[k][0] <= CHAIN_F32_MARGIN * p_f[k][0]
          for k in k_p}
    control_ok = {k: e_f[k][0] <= CHAIN_F32_MARGIN * p_f[k][0] for k in e_f}
    biased_close = {k: close(b_p, k) for k in b_p}
    phase('bf16_session_vs_plain_trunk', path=path,
          kernel_vs_plain=k_p, exact_vs_plain=e_p, kernel_vs_float32=k_f,
          plain_vs_float32=p_f, exact_vs_float32=e_f,
          biased_vs_plain=b_p, biased_vs_float32=b_f,
          within_u8_limit={'kernel': issue_limit,
                           'exact': {k: v[0] <= SESSION_U8_MEAN
                                     and v[1] >= SESSION_U8_WITHIN_2
                                     for k, v in e_p.items()}},
          u8_limit=[SESSION_U8_MEAN, SESSION_U8_WITHIN_2],
          margins=[SESSION_MARGIN, SESSION_SHARE_SLACK, CHAIN_F32_MARGIN],
          ok=ok, exact_control_ok=control_ok,
          biased_control_close=biased_close)
    check(all(control_ok.values()), f'{path}: the exact control\'s session '
                                    f'is less accurate than the plain '
                                    f'trunk\'s: {e_f} vs {p_f}')
    check(not any(biased_close.values()),
          f'{path}: the round-toward-zero control\'s session passes the '
          f'closeness bound ({b_p} against the exact control\'s {e_p}): the '
          'bound does not see a one-ulp bias')
    check(all(ok.values()), f'{path}: session vs the plain trunk {k_p} (exact '
                            f'control {e_p}), vs float32 {k_f} (plain {p_f})')


def float32_twin(net, x):
    """The same translator at float32 with its float32 kernel trunk: the
    reference that a lower precision's own rounding noise is read from."""
    with net_attrs(net, compute_dtype=torch.float32, int8_mode=None,
                   fuse_stages=False):
        return net(x.float()).float()


def slice_checks(M, K, md, img, precision, fuse_stages=False,
                 f32_images=None):
    """The main path at ``precision`` (with the fused translator stages
    when ``fuse_stages``) through the user entry point, then run-to-run
    equality, the launch counts, a full-width translator against its twin
    (plain trunk, or the unfused stages), batch invariance, throughput and
    per-net times."""
    FR = K[0]
    path = precision + (' fuse_stages' if fuse_stages else '')
    scope = 'resblocks' if precision == 'int8' else None
    kw = dict(device='cuda', max_batch=BATCH, precision=precision,
              int8_scope=scope, fuse_stages=fuse_stages)
    t0 = time.perf_counter()
    session = M.init_nets(md, **kw)
    phase('session', path=path, seconds=time.perf_counter() - t0,
          ngf=session.d.ngf, net_g=session.d.net_g, net_gs=session.d.net_gs,
          dtype=session.d.dtype, int8_mode=session.nets.G[0].int8_mode,
          fuse_stages=session.nets.G[0].fuse_stages)
    forwards = []
    run_batch = session.forward
    session.forward = lambda *a, **k: forwards.append(1) or run_batch(*a, **k)

    # the main path, through the user entry point: tiler, run_tiles,
    # stitch, host postprocess; counts read just before and just after
    torch.cuda.synchronize()
    reset_counts(K)
    t0 = time.perf_counter()
    images, scoring = M.infer_modalities(img, TILE, md, device_quant=False,
                                         **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts(K)
    n_forwards = len(forwards)
    phase('main_path', path=path, seconds=seconds, batch_forwards=n_forwards,
          kernel_launches=counts, outputs=sorted(images), scoring=scoring)
    check(n_forwards >= 1, 'no batch forward ran')
    want = expected_counts(precision, fuse_stages, n_forwards)
    check(counts == want, f'{path} path: kernel launches {counts} for '
                          f'{n_forwards} forwards, want {want}')
    check(set(images) == OUTPUTS, f'outputs {sorted(images)}')
    for k, im in images.items():
        a = np.asarray(im)
        check(a.shape == (2 * TILE, 2 * TILE, 3) and a.dtype == np.uint8,
              f'{k}: {a.shape} {a.dtype}')
    check({'num_total', 'num_pos', 'num_neg', 'percent_pos'} <= set(scoring),
          f'scoring keys {sorted(scoring)}')

    images2, scoring2 = M.infer_modalities(img, TILE, md, device_quant=False,
                                           **kw)
    same = all(np.array_equal(np.asarray(images[k]), np.asarray(images2[k]))
               for k in images) and scoring == scoring2
    phase('run_to_run', path=path, byte_equal=same)
    check(same, 'two runs differ')

    # one full-width translator against its twin: the plain trunk composed
    # from the module's public pieces, or (fused stages) the unfused stages
    # with the same trunk kernel
    net = session.nets.G[0]
    tiles = np.stack([np.asarray(img)[y:y + TILE, x:x + TILE]
                      for y, x in ((0, 0), (TILE, TILE))])
    xin = (torch.from_numpy(tiles).cuda().float() / 127.5 - 1.0).permute(
        0, 3, 1, 2).to(session.d.dtype)
    with torch.no_grad():
        got = net(xin).float()
        if fuse_stages:
            with net_attrs(net, fuse_stages=False):
                want = net(xin).float()
        else:
            trunk_in = net.head(xin)
            if net.int8_mode is None:
                plain = FR.resblock_chain_reference(
                    trunk_in, net.trunk_blocks(), padding=net.padding_type)
            else:
                plain = FR.resblock_chain_int8_reference(
                    trunk_in, net.trunk_blocks(), padding=net.padding_type,
                    dynamic=net.int8_mode == 'dynamic')
            want = net.tail(plain).float()
        twin = None if precision == 'float32' else float32_twin(net, xin)
    noise = None if twin is None else (want - twin).abs()
    d = (got - want).abs()
    err, mean_err = d.max().item(), d.mean().item()
    noise_max, noise_mean = (None, None) if noise is None else \
        (noise.max().item(), noise.mean().item())
    phase('translator_vs_unfused_stages' if fuse_stages else
          'translator_vs_plain_trunk', path=path, shape=list(got.shape),
          finite=bool(torch.isfinite(got).all()), max_abs_err=err,
          mean_abs_err=mean_err, twin_vs_float32_max=noise_max,
          twin_vs_float32_mean=noise_mean)
    check(bool(torch.isfinite(got).all()), 'non-finite translator output')
    if noise is None:
        check(err <= TRANSLATOR_TOL_F32,
              f'translator error {err} > {TRANSLATOR_TOL_F32}')
    elif fuse_stages:
        got_vs_f32 = (got - twin).abs().mean().item()
        phase('translator_vs_float32', path=path, fused_mean_abs=got_vs_f32,
              unfused_mean_abs=noise_mean)
        check(mean_err <= noise_mean and err <= noise_max
              and got_vs_f32 <= FUSED_VS_F32_MARGIN * noise_mean,
              f'fused translator: vs unfused mean {mean_err}, max {err}, vs '
              f'float32 mean {got_vs_f32}, against bf16 noise mean '
              f'{noise_mean}, max {noise_max}')
    elif precision == 'bfloat16':
        got_vs_f32 = (got - twin).abs().mean().item()
        phase('translator_vs_float32', path=path,
              kernel_trunk_mean_abs=got_vs_f32,
              plain_trunk_mean_abs=noise_mean, margin=CHAIN_F32_MARGIN)
        check(got_vs_f32 <= CHAIN_F32_MARGIN * noise_mean
              and err <= noise_max,
              f'bf16 translator: kernel trunk vs float32 mean {got_vs_f32} '
              f'against the plain trunk\'s {noise_mean}; vs plain trunk max '
              f'{err} against the noise max {noise_max}')
    else:
        check(mean_err <= TRANSLATOR_NOISE_SHARE * noise_mean
              and err <= noise_max,
              f'translator error mean {mean_err}, max {err} against '
              f'{precision} noise mean {noise_mean}, max {noise_max}')
    if precision == 'bfloat16':
        session_vs_plain_trunk(M, FR, md, img, images, f32_images, kw, path)

    rng = np.random.default_rng(SEED + 1)
    big = np.asarray(img)
    origins = rng.integers(0, 2 * TILE - TILE + 1, (BATCH, 2))
    batch = np.stack([big[y:y + TILE, x:x + TILE] for y, x in origins])

    # batch invariance of the whole path: one tile alone vs in a batch
    full = session.run_tiles(batch)
    alone = session.run_tiles(batch[3:4])
    inv = {k: bool(np.array_equal(full[k][3], alone[k][0])) for k in full}
    phase('batch_invariance', path=path, tile_alone_vs_in_batch=inv,
          byte_equal=all(inv.values()))
    check(all(inv.values()), f'{path}: a tile alone differs from the same '
                             f'tile in a batch of {BATCH}: {inv}')

    tput = throughput(session, batch)
    t0 = time.perf_counter()
    session.run_tiles(batch[3:4])
    tput['one_tile_ms'] = (time.perf_counter() - t0) * 1e3
    phase('throughput', path=path, default_max_batch=session.max_batch
          == M.DEFAULT_MAX_BATCH, **tput)

    xb = (torch.from_numpy(batch).cuda().float() / 127.5 - 1.0).permute(
        0, 3, 1, 2).to(session.d.dtype)
    with torch.no_grad():
        ms = {'translator': cuda_ms(lambda: net(xb), 2),
              'translator_trunk': cuda_ms(lambda: net.trunk(net.head(xb)), 2),
              'seg_unet_512': cuda_ms(lambda: session.nets.GS[0](xb), 2)}
    phase('per_net_ms', path=path, batch=BATCH, **ms,
          ensemble_estimate_ms=4 * ms['translator'] + 5 * ms['seg_unet_512'])
    del session.forward            # the class's method again
    return counts, tput, images


def synthetic_seg_canvas(h, w, seed, device='cuda'):
    """A seg output the size of a slide region with IHC-like nuclei: one
    disk per CELL_GRID^2 grid cell (radius 4-11 px, inside its cell),
    positive (red) or negative (blue) at 4:6, a tenth of the large ones with
    an enclosed 'unknown' hole; a second, sparser layer on the grid shifted
    by half a cell (radius 1-11 px: specks below the noise gate, and disks
    that touch or overlap the first layer, merging into mixed components).
    The marker is noise 0-39 with bright (250-255) or dim (60-120) cells;
    the original a light noisy background. Returns uint8 tensors on
    ``device``: orig (h, w, 3), seg (h, w, 3), marker (h, w)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    seg = torch.zeros((h, w, 3), dtype=torch.uint8, device=device)
    marker = torch.randint(0, 40, (h, w), generator=gen, device=device,
                           dtype=torch.uint8)
    colors = torch.tensor([[25, 30, 230], [230, 25, 30], [0, 100, 0]],
                          dtype=torch.uint8, device=device)
    g = CELL_GRID
    for off, present, r_lo in ((0, 1.0, 4.0), (g // 2, 0.3, 1.0)):
        gh, gw = (h - off) // g + 1, (w - off) // g + 1
        r = rng.uniform(r_lo, 11.0, (gh, gw))
        lo, hi = (r + 1, g - r - 1) if off == 0 else (0.0, float(g))
        cy = rng.uniform(lo, hi, (gh, gw)) + (np.arange(gh) * g + off)[:, None]
        cx = rng.uniform(lo, hi, (gh, gw)) + (np.arange(gw) * g + off)[None, :]
        on = rng.random((gh, gw)) < present
        kind = (rng.random((gh, gw)) < 0.4).astype(np.int64)
        kind = np.where((rng.random((gh, gw)) < 0.1) & (r > 7) & (off == 0),
                        kind + 10, kind)                 # +10: with a hole
        mval = np.where(rng.random((gh, gw)) < 0.35,
                        rng.integers(250, 256, (gh, gw)),
                        rng.integers(60, 121, (gh, gw)))
        iy = ((torch.arange(h, device=device) - off).clamp(min=0) // g
              ).clamp(max=gh - 1)[:, None]
        ix = ((torch.arange(w, device=device) - off).clamp(min=0) // g
              ).clamp(max=gw - 1)[None, :]

        def at(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)[iy, ix]
        d2 = (yy - at(cy.astype(np.float32))) ** 2 \
            + (xx - at(cx.astype(np.float32))) ** 2
        disk = (d2 < at((r * r).astype(np.float32))) & at(on)
        k = at(kind)
        hole = disk & (k >= 10) & (d2 < 2.0)
        seg = torch.where(disk[..., None], colors[k % 10], seg)
        seg = torch.where(hole[..., None], colors[2], seg)
        marker = torch.where(disk, at(mval.astype(np.uint8)), marker)
        del d2, disk, k, hole
    base = torch.tensor([215, 205, 200], dtype=torch.int16, device=device)
    noise = torch.randint(-8, 9, (h, w, 3), generator=gen, device=device,
                          dtype=torch.int16)
    orig = (base + noise).clamp(0, 255).to(torch.uint8)
    return orig, seg, marker


def label_masks(LB, seg):
    """The two masks the quantifier labels: the unknown pixels (conn 4, the
    background flood) and, after the flood, the cell mask (conn 8)."""
    mask = LB.posneg_mask(seg, 120)
    return {4: mask == LB.LABEL_UNKNOWN,
            8: LB.flood_background(mask) != LB.LABEL_BACKGROUND}


def kernel_checks_label(LB, canvases):
    """label_components at conn 4 and 8 on the masks of each canvas:
    bit-equal to the plain labeling, byte-equal run to run, timed in turns
    against it. The bound: the mask read once (1 B/px) and the labels
    written once (4 B/px) over HBM. Returns {(h, w, conn): numbers}."""
    out = {}
    for (h, w), (_, seg, _) in canvases.items():
        for conn, fg in label_masks(LB, seg).items():
            c8 = conn == 8
            got = LB.label_components(fg, conn8=c8)
            want = LB.label_components_reference(fg, conn8=c8)
            again = LB.label_components(fg, conn8=c8)
            torch.cuda.synchronize()
            err = (got.long() - want.long()).abs().max().item()
            roots = (got.reshape(-1) == torch.arange(
                1, h * w + 1, device=got.device, dtype=torch.int32))
            phase('kernel_vs_plain', kernel='label_components', canvas=[h, w],
                  conn=conn, fg_share=fg.float().mean().item(),
                  components=int(roots.sum()), bit_equal=err == 0,
                  max_abs_err=err)
            check(err == 0, f'label_components {h}x{w} conn {conn}: labels '
                             f'differ from the plain labeling by {err}')
            check(torch.equal(got, again), f'label_components {h}x{w} conn '
                                           f'{conn}: two launches differ')
            phase('kernel_deterministic', kernel='label_components',
                  canvas=[h, w], conn=conn, two_launches_byte_equal=True)
            del got, want, again, roots
            runs, ms = in_turns({
                'plain': lambda: LB.label_components_reference(fg, conn8=c8),
                'kernel': lambda: LB.label_components(fg, conn8=c8)},
                {'plain': 1, 'kernel': 5})
            bound_ms = h * w * (1 + 4) / PEAK_BYTES * 1e3
            phase('kernel_timing', kernel='label_components', canvas=[h, w],
                  conn=conn, runs_ms=runs,
                  **{f'{k}_ms': v for k, v in ms.items()}, bound_ms=bound_ms,
                  bound_by='bytes',
                  library_call='none: PyTorch has no connected-components '
                               'call')
            out[(h, w, conn)] = dict(err=err, ms=ms['kernel'],
                                     plain_ms=ms['plain'], bound_ms=bound_ms)
            torch.cuda.empty_cache()
    return out


def device_quant_checks(LB, pp, canvases):
    """The device quantifier (size and marker thresholds 'default') on each
    canvas: with the labeling kernel and with the plain labeling, byte-equal
    overlay and refined and equal scoring; its time (host clock, results
    fetched) and peak device memory per MPx; at the ROI canvas the counts of
    the host quantifier, with and without the marker, and its time."""
    out = {}
    kw = dict(size_thresh='default', marker_thresh='default')
    for (h, w), (orig, seg, marker) in canvases.items():
        orig_np, marker_np = orig.cpu().numpy(), marker.cpu().numpy()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = LB.compute_final_results_device(orig_np, seg, marker_np, '40x',
                                              **kw)
        peak = torch.cuda.max_memory_allocated() - base
        plain = LB.compute_final_results_device(
            orig_np, seg, marker_np, '40x',
            labeler=LB.label_components_reference, **kw)
        same = (got[2] == plain[2] and np.array_equal(got[0], plain[0])
                and np.array_equal(got[1], plain[1]))
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            LB.compute_final_results_device(orig_np, seg, marker_np, '40x',
                                            **kw)
            secs.append(time.perf_counter() - t0)
        mpx = h * w / 1e6
        res = dict(canvas=[h, w], scoring=got[2], seconds_runs=secs,
                   seconds=sum(secs) / len(secs), peak_mem_bytes=peak,
                   peak_bytes_per_px=peak / (h * w), mpx=mpx)
        phase('device_quant', kernel_vs_plain_labeling_equal=same, **res)
        check(same, f'device quantifier {h}x{w}: the labeling kernel and '
                    f'the plain labeling give other results: {got[2]} vs '
                    f'{plain[2]}')
        check(got[0].shape == (h, w, 3) and got[2]['num_total'] > 0,
              f'device quantifier {h}x{w}: {got[0].shape} {got[2]}')
        if (h, w) == QUANT_CANVASES[-1]:
            check(got[2]['num_total'] > 16384,
                  f'{got[2]["num_total"]} cells: the KDE compaction to the '
                  '16384 largest does not run')
        if (h, w) == QUANT_CANVASES[0]:
            seg_np = seg.cpu().numpy()
            for mk, mt in ((None, None), (marker_np, 'default')):
                dev = LB.compute_final_results_device(orig_np, seg, mk, '40x',
                                                      marker_thresh=mt)[2]
                t0 = time.perf_counter()
                host = pp.compute_final_results(orig_np, seg_np, mk, '40x',
                                                marker_thresh=mt)[2]
                host_s = time.perf_counter() - t0
                counts = {k: (dev[k], host[k])
                          for k in ('num_total', 'num_pos', 'num_neg')}
                phase('device_vs_host_quant', canvas=[h, w],
                      marker=mk is not None, counts_device_host=counts,
                      thresholds_device=(dev['size_thresh'],
                                         dev['marker_thresh']),
                      thresholds_host=(host['size_thresh'],
                                       host['marker_thresh']),
                      host_seconds=host_s)
                check(all(a == b for a, b in counts.values()),
                      f'device vs host counts at {h}x{w}: {counts}')
                res['host_seconds'] = host_s
        out[(h, w)] = res
        del got, plain
        torch.cuda.empty_cache()
    return out


def devquant_main_path(M, K, md, img, pp):
    """The float32 main path with ``device_quant=True`` through the user
    entry point: the seg tiles stay on the card, are stitched there and
    quantified there. Against the host-quantifier run of the same session:
    'Seg' and every modality byte-equal, scoring equal; run to run
    byte-equal; the launch counts of the float32 path plus two labeling
    launches; on the canvas it stitched, the labeling kernel bit-equal to
    the plain labeling, and the plain labeling's quantifier giving the
    path's overlay, refined and scoring."""
    kw = dict(device='cuda', max_batch=BATCH, precision='float32')
    session = M.init_nets(md, **kw)
    forwards = []
    run_batch = session.forward
    session.forward = lambda *a, **k: forwards.append(1) or run_batch(*a, **k)
    host_images, host_scoring = M.infer_modalities(img, TILE, md,
                                                   device_quant=False, **kw)
    torch.cuda.synchronize()
    reset_counts(K)
    forwards.clear()
    t0 = time.perf_counter()
    images, scoring = M.infer_modalities(img, TILE, md, device_quant=True,
                                         **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts(K)
    n_forwards = len(forwards)
    want = expected_counts('float32', False, n_forwards, quant_calls=1)
    phase('main_path', path='float32 device_quant', seconds=seconds,
          batch_forwards=n_forwards, kernel_launches=counts,
          outputs=sorted(images), scoring=scoring)
    check(counts == want, f'device_quant path: kernel launches {counts} for '
                          f'{n_forwards} forwards, want {want}')
    check(set(images) == OUTPUTS, f'outputs {sorted(images)}')
    equal = {k: bool(np.array_equal(np.asarray(images[k]),
                                    np.asarray(host_images[k])))
             for k in OUTPUTS - {'SegOverlaid', 'SegRefined'}}
    phase('device_vs_host_quant_path', seg_and_modalities_byte_equal=equal,
          scoring_equal=scoring == host_scoring, host_scoring=host_scoring)
    check(all(equal.values()), f'device_quant path differs from the host '
                               f'quantifier run: {equal}')
    check(scoring == host_scoring, f'scoring {scoring} vs {host_scoring}')
    for k in ('SegOverlaid', 'SegRefined'):
        a = np.asarray(images[k])
        check(a.shape == (2 * TILE, 2 * TILE, 3) and a.dtype == np.uint8,
              f'{k}: {a.shape} {a.dtype}')

    # the labeling kernel on the main path's own canvas: the seg canvas
    # this session stitches on the card, labeled by the kernel and by the
    # plain labeling (bit-equal), and quantified with the plain labeling
    # (the main path's overlay, refined and scoring, byte for byte)
    LB = K[3]
    _, canvas = M.inference(img, TILE, TILE // 16, md, session=session,
                            _device_seg=True)
    check(canvas is not None and canvas.is_cuda
          and np.array_equal(canvas.cpu().numpy(), np.asarray(images['Seg'])),
          "the device stitch did not run or differs from 'Seg'")
    labels = {}
    for conn, fg in label_masks(LB, canvas).items():
        got = LB.label_components(fg, conn8=conn == 8)
        want = LB.label_components_reference(fg, conn8=conn == 8)
        roots = got.reshape(-1) == torch.arange(
            1, fg.numel() + 1, device=got.device, dtype=torch.int32)
        labels[conn] = dict(bit_equal=torch.equal(got, want),
                            fg_share=fg.float().mean().item(),
                            components=int(roots.sum()))
    marker = images.get(M.find_marker_key(images))
    check(marker is not None, f'no marker among {sorted(images)}')
    plain = LB.compute_final_results_device(
        np.asarray(img.convert('RGB')), canvas, pp.to_array(marker, True),
        '40x', labeler=LB.label_components_reference)     # tile 512: 40x
    same = (plain[2] == scoring
            and np.array_equal(plain[0], np.asarray(images['SegOverlaid']))
            and np.array_equal(plain[1], np.asarray(images['SegRefined'])))
    phase('kernel_vs_plain', kernel='label_components',
          canvas=list(canvas.shape[:2]), on='the device_quant main path',
          labels_by_conn=labels, quantifier_vs_plain_labeling_equal=same)
    check(all(v['bit_equal'] for v in labels.values()),
          f'label_components on the main path canvas: labels differ from '
          f'the plain labeling: {labels}')
    check(same, f'device_quant main path: overlay, refined or scoring differ '
                f'from the plain labeling\'s: {scoring} vs {plain[2]}')
    del canvas, got, want, roots

    images2, scoring2 = M.infer_modalities(img, TILE, md, device_quant=True,
                                           **kw)
    same = all(np.array_equal(np.asarray(images[k]), np.asarray(images2[k]))
               for k in images) and scoring == scoring2
    phase('run_to_run', path='float32 device_quant', byte_equal=same)
    check(same, 'two device_quant runs differ')
    del session.forward
    return counts


def main():
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is false: '
          'chip_smoke.py needs a CUDA card')
    smi = nvidia_smi()
    phase('device', nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    t_start = time.perf_counter()

    from PIL import Image
    from deepliif_tpu_torch import models as M, postprocessing as pp
    from deepliif_tpu_torch.labs import fused_stages as FS
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.ops import cuda_build, fused_resblock as FR
    from deepliif_tpu_torch.ops import labeling as LB
    from deepliif_tpu_torch.utils import checkpoints as ck

    M.configure_device(torch.device('cuda'))   # TF32 off for the plain paths
    t0 = time.perf_counter()
    # every kernel library of the path, one nvcc each, all started together
    cuda_build.build({**FR._LIBS, **FS._LIBS, **L._LIBS, **LB._LIBS})
    phase('build', seconds=time.perf_counter() - t0, parallel=True,
          nvcc_seconds=cuda_build.build_seconds)

    rnd = Rand(SEED)
    err = {'float32': kernel_checks_f32(FR, rnd),
           'bfloat16': kernel_checks_bf16(FR, rnd),
           'int8': kernel_checks_int8(FR, rnd)}
    ms = kernel_timing(FR, rnd)
    stages = kernel_checks_stages(FS, FR, rnd)
    tail = kernel_checks_tail(FS, FR, rnd)
    plane = kernel_checks_plane(L, rnd)
    canvases = {hw: synthetic_seg_canvas(*hw, SEED + i)
                for i, hw in enumerate(QUANT_CANVASES)}
    label = kernel_checks_label(LB, canvases)
    quant = device_quant_checks(LB, pp, canvases)
    del canvases
    torch.cuda.empty_cache()
    phase('kernel_checks', seconds=time.perf_counter() - t0)

    launches, tput, images = {}, {}, {}
    img = Image.fromarray(ihc_like_image(2 * TILE, SEED))
    K = (FR, FS, L, LB)
    with tempfile.TemporaryDirectory() as md:
        write_flagship_model_dir(md, dl, ck)
        for precision, fused in (('float32', False), ('bfloat16', False),
                                 ('int8', False), ('bfloat16', True)):
            key = 'fused' if fused else precision
            launches[key], tput[key], images[key] = slice_checks(
                M, K, md, img, precision, fused, images.get('float32'))
            if key == 'float32':
                launches['devquant'] = devquant_main_path(M, K, md, img, pp)
            # one session on the card at a time, so that peak memory is
            # the next path's own
            M._init_nets_cached.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()

    loaded = sorted(m for m in sys.modules if m == 'jax' or m == 'deepliif_tpu'
                    or m.startswith(('jax.', 'jaxlib', 'deepliif_tpu.')))
    phase('imports', jax_or_deepliif_tpu_modules=loaded,
          seconds_total=time.perf_counter() - t_start)
    check(not loaded, f'jax or deepliif_tpu was imported: {loaded}')

    report = []
    for name, kind, replaces, elem, wb, extra in (
            ('conv3x3_stats', 'float32', ':158', 4, 4,
             {'design': 'split TF32 (3 TF32 products per multiply-add)'}),
            ('conv3x3_stats', 'bfloat16', ':158', 2, 2, {}),
            ('conv3x3_stats_int8', 'int8', ':348', 2, 1,
             {'mode': 'dynamic', 'static_ms': ms['int8']['static']})):
        bound_ms, bound_by = bound(kind, TIMING_SHAPE, elem, wb)
        report.append({
            'name': f'{name} ({kind})' if name == 'conv3x3_stats' else name,
            'route': 'cuda',
            'source': 'deepliif_tpu_torch/csrc/conv3x3_wgmma.cuh',
            'entry': f'deepliif_tpu_torch/csrc/{name}.cu',
            'replaces': f'deepliif_tpu/ops/fused_resblock.py{replaces}',
            'launches': launches[kind][kind], 'max_abs_err': err[kind],
            'ms': ms[kind]['kernel'], 'plain_ms': ms[kind]['plain'],
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': ms[kind]['library'], **extra})
    for name, replaces in (('conv3x3_s2_stats', ':141'),
                           ('convtranspose3_s2_stats', ':292')):
        st = stages[name]
        report.append({
            'name': name, 'route': 'cuda',
            'source': 'deepliif_tpu_torch/csrc/conv3x3_wgmma.cuh',
            'entry': f'deepliif_tpu_torch/csrc/{name}.cu',
            'replaces': f'deepliif_tpu/labs/fused_stages.py{replaces}',
            'launches': launches['fused'][name], 'max_abs_err': st['err'],
            'ms': st['ms'], 'plain_ms': st['plain_ms'],
            'bound_ms': st['bound_ms'], 'bound_by': st['bound_by'],
            'library_ms': st['library_ms'], 'per_call': st['per_call'],
            'per': f'its two calls per translator ({", ".join(st["calls"])})'
                   f', summed, at batch {BATCH}'})
    tl = tail['zero']           # the flagship's padding (its config.json)
    report.append({
        'name': 'tail_s2d', 'route': 'cuda',
        'source': 'deepliif_tpu_torch/csrc/tail_s2d.cu',
        'replaces': 'deepliif_tpu/labs/fused_stages.py:483',
        'launches': launches['fused']['tail_s2d'],
        'max_abs_err': max(v['err'] for v in tail.values()),
        'ms': tl['ms'], 'plain_ms': tl['plain_ms'],
        'bound_ms': tl['bound_ms'], 'bound_by': tl['bound_by'],
        'library_ms': tl['library_ms'], 'reflect_ms': tail['reflect']['ms'],
        'per': f'one translator tail, ({BATCH}, {TILE}, {TILE}, 64) -> 3, '
               'zero padding, at batch 16'})
    pl = plane['bfloat16']
    report.append({
        'name': 'plane_stats', 'route': 'cuda',
        'source': 'deepliif_tpu_torch/csrc/plane_stats.cu',
        'replaces': 'deepliif_tpu/nets/layers.py:541 (XLA reductions of '
                    'batch_stat_norm; no TPU kernel)',
        'launches': launches['float32']['plane_stats'],
        'max_abs_err': max(v['err'] for v in plane.values()),
        'ms': pl['ms'], 'plain_ms': pl['plain_ms'], 'bound_ms': pl['bound_ms'],
        'bound_by': 'bytes', 'library_ms': pl['library_ms'],
        'float32': plane['float32'],
        'nchw_float32': plane['up_norms']['nchw_float32'],
        'up_norm_cases': plane['up_norms']['cases'],
        'per': f'one norm (one call, x read once) of ({BATCH}, 64, {TILE}, '
               f'{TILE}) bf16; float32 beside it, and the largest float32 '
               'up-norm in NCHW memory'})
    big = QUANT_CANVASES[-1]
    lab = [label[(*big, conn)] for conn in (4, 8)]
    report.append({
        'name': 'label_components', 'route': 'cuda',
        'source': 'deepliif_tpu_torch/csrc/label_cc.cu',
        'replaces': 'deepliif_tpu/ops/labeling.py:410',
        'launches': launches['devquant']['label_components'],
        'max_abs_err': max(v['err'] for v in label.values()),
        'ms': sum(v['ms'] for v in lab),
        'plain_ms': sum(v['plain_ms'] for v in lab),
        'bound_ms': sum(v['bound_ms'] for v in lab), 'bound_by': 'bytes',
        'library_ms': None, 'canvas': list(big),
        'per': 'the two launches of one quantifier call (conn 4 on the '
               'unknown mask, conn 8 on the cell mask), summed',
        'roi_ms': sum(label[(*QUANT_CANVASES[0], c)]['ms'] for c in (4, 8)),
        'quantifier_seconds': {f'{h}x{w}': q['seconds']
                               for (h, w), q in quant.items()}})
    print(json.dumps({'kernels': report}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
