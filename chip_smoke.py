"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels from this checkout, checks each against its plain PyTorch version
at the shapes of the main path, then drives flagship DeepLIIF inference
(4 x resnet_9blocks + 5 x unet_512, ngf 64, 512^2 tiles, random weights from
a seed) end to end through the port's user entry points, at float32,
bfloat16, int8 (ResNet-trunk scope, per-chunk dynamic scales), bfloat16
with the fused translator stages (``fuse_stages``, which end in the tail
kernel ``tail_s2d_fused``) and int8 scope 'all' (the JAX package's default
``--precision int8``: every conv with 16 channels or more in and out
quantized; the trunk on the int8 trunk kernel, the 96 others on
``conv_s8``), calibrated on the first tiles (static) and with calibration
off (dynamic, 92 ``conv_s8`` calls: the 512^2 down convs run float). The
``conv_s8`` kernel (the bf16 input quantized in its load) is held
bit-equal to its plain version at every call of that forward, static and
dynamic, run to run and per sample, and a
translator of the int8 'all' session byte-equal with the kernel swapped
for its plain version. The float32 trunk kernel (split TF32 on the
tensor cores) is held to the float32 tolerance beside two controls on the
same inputs: cuDNN's 1x TF32 conv must fail it, the plain 3x TF32 emulation
must pass it. Every path must give
tiles alone and in small batches (1, 2, 4, 8, 9) the outputs they get
inside a batch of 16 (``batch_invariance``; the engine runs a short
batch in a power-of-two bucket only where its probe holds it bitwise
against the full batch), and 40 tiles with four empty ones in one
pipelined ``run_tiles`` call (two batches in flight) the bytes of the
same tiles 16 at a time, with no host wait inside a forward and at most
one between launches (``pipeline``, traced with ``utils.profiling``). The
bf16 trunk is held to accuracy against float32, beside two controls that
must come out either way (``bf16_chain_check``: an exactly rounded conv
passes, a conv rounded toward zero fails), on its 9-block chain, on one
translator and on the bf16 sessions' outputs (``session_vs_plain_trunk``).
The device quantifier (``device_quant``) is checked on synthetic seg canvases
of 1536x1280 (an ROI) and 8192x8192 (67.1 MPx) with its labeling kernel
against the plain labeling and against the host quantifier, and drives the
float32 main path once more with ``device_quant=True``. The labeling kernel
is also held to the plain labeling on masks made to stress its tile borders
(``adversarial_masks``), to scipy's labels on its worst case at 67.1 MPx,
and one 67.1 MPx quantifier call is traced by op (``devquant_breakdown``).
On the flagship dir the script also drives seg-only (``seg_only``, at
float32 and bfloat16, with the config's seg weights and the legacy (0.5,
0, 0, 0, 0.5): Seg and the marker byte-equal to the full forward, 18
trunk launches per translator run) and the seg intermediates
(``seg_intermediate``, float32: GS0..GS4, GS byte-equal to the full
forward, run to run); then the other model families at their published
defaults through ``infer_modalities`` (``family_checks``: DeepLIIFExt,
4 x resnet_9blocks + 4 x unet_512 on 9 channels; SDG, 4 modalities on 2
inputs; CycleGAN, GA and BtoA), each float32 whatever the precision asked,
byte-equal run to run and batch-invariant, 72 / 72 / 18 trunk launches,
and within 1 LSB on < 0.1 % of pixels of the same session with the plain
versions of its kernels; and a flagship dir with ``unet_512_attention``
seg nets at float32, bfloat16 and int8 scope 'all' (``att_unet_checks``:
every ``conv_s8`` call of an int8 forward, the 1x1 gate convs among them,
bit-equal to its plain version). Then the serving, serialize and
whole-slide entry points on the float32 flagship dir: the REST server
(``serve.make_server`` on 127.0.0.1, any free port, ``max_batch`` 18) with
2 concurrent 1024^2 /api/infer requests queued together behind the
dispatcher's device lock, at least one device call coalescing requests,
each response byte-equal to the request sent alone and to ``inference``
plus the host quantifier on the session directly, /api/batch/infer, a
/api/postprocess and a 400 (``serve_checks``); ``serialize`` of a
reference-layout flagship dir on the card, its parity gate and the npz
against ``params_to_jax`` (``serialize_checks``); ``test-wsi`` and
``wsi-cells`` through the CLI on a 1600 x 1200 pyramidal TIFF at AppMag
40 in four regions, the outputs byte-equal run to run and to the
per-region stitch, the scoring and the cells the per-region sums
(``wsi_checks``); the same server at ``--precision int8``, dynamic and
static, its launches of #2 and ``conv_s8`` per forward
(``serve_int8_checks``); the CLI's ``eval`` over one aligned row, each
written image byte-equal to ``run_tiles`` of the row's A tile
(``eval_checks``). Each of these paths reads its kernel launches. Last,
training at float32: the statistics kernel under autograd
(``plane_mean_var_train``, forward and backward) against autograd of its
plain version (``train_stats_checks``), one step of a narrow flagship
layout on the card against the same step on the CPU (``train_step_vs_cpu``:
every loss term and gradient), and the full-width flagship through the
CLI's ``train`` (batch 2, 512^2, 3 steps, one ``latest`` save; s/step,
peak memory, statistics launches a step, the max |Δparam| of two identical
runs) with its checkpoint served back through ``test`` (``train_checks``);
then the other families' training: one step each of DeepLIIFExt, SDG,
CycleGAN (both steps, the host image pools between them) and DeepLIIFKD
(its teacher's trunk on the float32 trunk kernel) at ngf 16 on the card
against the same step on the CPU (``train_families_vs_cpu``: every loss
term and gradient), each at full width through the CLI's ``train``
(``train_ext``, ``train_sdg``, ``train_cyclegan``, ``train_kd``: 3 steps,
one ``latest`` save; statistics and trunk launches a step, 72 trunk
launches a step for DeepLIIFKD's teacher, none in the others), and the
Ext checkpoint served through ``test`` (``train_ext_checkpoint_served``).

    python3 chip_smoke.py            # needs one CUDA card; exits 0 on success

Prints one line per phase, then the kernel report as a JSON line, the card's
name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before that line. There is no CPU path.
"""

from __future__ import annotations

import contextlib
import copy
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
# the adversarial masks (adversarial_masks) against the plain labeling at a
# square and a ragged size it labels in seconds; the worst case of the
# kernel's own timing (the comb: its teeth cross every horizontal tile
# border, and all pieces join one root) at the largest canvas, held to scipy
LABEL_ADVERSARIAL_SHAPES = ((2048, 2048), (2047, 3001))
LABEL_WORST_CASE = 'comb'
# int8 scope 'all' (the JAX package's default --precision int8): every conv
# with C_in and C_out >= 16 quantizes. The trunk's 72 run kernel #2; the
# others run conv_s8 (csrc/conv_s8.cu), one call each per batch forward:
# (call, kind, x shape, C_out, k, output_padding), all stride 2 padding 1;
# per translator down0, down1 (3x3) and up0, up1 (conv-transpose 3x3,
# output_padding 1); per unet_512 the 8 inner blocks' downconv (4x4) and
# upconv (conv-transpose 4x4), the outermost block's (3 channels) float
S8_CALLS = (
    ('translator down0', 'conv', (BATCH, 512, 512, 64), 128, 3, 0),
    ('translator down1', 'conv', (BATCH, 256, 256, 128), 256, 3, 0),
    ('translator up0', 'convT', (BATCH, 128, 128, 256), 128, 3, 1),
    ('translator up1', 'convT', (BATCH, 256, 256, 128), 64, 3, 1)) + tuple(
    (f'unet down {h}', 'conv', (BATCH, h, h, cin), cout, 4, 0)
    for h, cin, cout in ((256, 64, 128), (128, 128, 256), (64, 256, 512),
                         (32, 512, 512), (16, 512, 512), (8, 512, 512),
                         (4, 512, 512), (2, 512, 512))) + tuple(
    (f'unet up {h}', 'convT', (BATCH, h, h, cin), cout, 4, 0)
    for h, cin, cout in ((1, 512, 512), (2, 1024, 512), (4, 1024, 512),
                         (8, 1024, 512), (16, 1024, 512), (32, 1024, 256),
                         (64, 512, 128), (128, 256, 64)))
S8_NETS = {'translator': 4, 'unet': 5}
# conv_s8 launches per batch forward: static scales every call above;
# dynamic scales send translator down0 (a 512^2 input, past the 256^2
# gate of the JAX package's _int8_ok) to the float path
S8_PER_FORWARD = {'static': 4 * 4 + 5 * 16, 'dynamic': 4 * 3 + 5 * 16}
# the timed conv_s8 call: the largest input of the forward
S8_TIMED = 'translator down0'
# seg-only and the seg intermediates (DeepLIIF, on the flagship dir): the
# seg weights of the model dir's config, and the legacy ones, where 1
# translator (Marker, which is also the marker output) and 2 seg nets run
# of 4 + 5; trunk launches per translator (9 blocks x 2 convs) and
# statistics calls per translator (5 norms) and per unet_512 (15)
LEGACY_SEG_WEIGHTS = (0.5, 0.0, 0.0, 0.0, 0.5)
TRUNK_PER_NET = 9 * 2
PLANE_PER_TRANSLATOR, PLANE_PER_UNET = 5, 15
# the attention U-Net's statistics calls: 6 encoder norms, 7 up norms and
# 3 per attention gate (7 gates); its int8 convs at scope 'all' (static
# scales): 7 down convs, 7 up conv-transposes, 14 1x1 gate convs (W_g,
# W_x; the outermost convs and psi have fewer than 16 channels)
PLANE_PER_ATT_UNET = 6 + 7 + 3 * 7
S8_PER_ATT_UNET = 7 + 7 + 14
# the other families at their published defaults (ngf 64, resnet_9blocks
# translators, unet_512 seg nets): (name, model option, modalities,
# input_no, seg nets, extra config); trunk launches per forward 72 / 72 /
# 18, statistics calls 4 x 5 + 4 x 15 / 4 x 5 / 5
FAMILY_CASES = (
    ('ext', 'DeepLIIFExt', 4, 1, 4, {'seg_gen': True, 'seg_no': 4,
                                     'net_gs': 'unet_512'}),
    ('sdg', 'SDG', 4, 2, 0, {'seg_gen': False, 'seg_no': 0}),
    ('cyclegan', 'CycleGAN', 1, 1, 0, {'seg_gen': False, 'seg_no': 0}),
    ('cyclegan_btoa', 'CycleGAN', 1, 1, 0, {'seg_gen': False, 'seg_no': 0,
                                            'BtoA': True}))
# a family session against the same session with the plain versions of its
# kernels (the trunk conv and the norm statistics): uint8 outputs within 1
# LSB on fewer than 0.1 % of pixels (the truncating cast flips where the
# two float32 results straddle an integer)
FAMILY_U8_SHARE = 1e-3
# calibration (static): the keys the flagship records (per translator 2
# down, 18 trunk and 2 up convs; per unet_512 16), and the statistics
# calls of one calibration batch: every norm of the float replay, whose
# trunk runs unfused on cuDNN (per translator 5 + 18 trunk norms, per
# unet_512 15)
CALIB_KEYS = 22 + 16
CALIB_BATCH = 4
CALIB_PLANE_PER_BATCH = 4 * (5 + 18) + 5 * 15


_T0 = time.perf_counter()


def phase(name, **info):
    """One JSON line per phase, with the seconds since the script began."""
    print(json.dumps({'phase': name, **info,
                      'elapsed_s': round(time.perf_counter() - _T0, 1)},
                     default=str), flush=True)


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


def write_model_dir(md, nets_, cfg, seed=SEED):
    """The groups of ``nets_`` (``named_groups``) in the native npz layout,
    weights at the reference init (conv ~ N(0, 0.02), norm scale ~ N(1,
    0.02), biases 0) drawn from a numpy seed, and ``cfg`` as config.json."""
    from deepliif_tpu_torch.utils import checkpoints as ck
    os.makedirs(md, exist_ok=True)
    rng = np.random.default_rng(seed)
    for group, mods in nets_.named_groups():
        if not len(mods):
            continue
        flat = ck.flatten_tree(ck.params_to_jax(mods[0]))
        out = {}
        for k, v in flat.items():
            shape = (len(mods),) + v.shape
            if k.endswith('/w'):
                out[k] = rng.normal(0, 0.02, shape).astype(np.float32)
            elif k.endswith('/scale'):
                out[k] = (1 + 0.02 * rng.normal(0, 1, shape)).astype(np.float32)
            else:
                out[k] = np.zeros(shape, np.float32)
        np.savez(os.path.join(md, f'latest_net_{group}.npz'), **out)
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump(cfg, f)


FLAGSHIP_CFG = {'model': 'DeepLIIF', 'modalities_no': 4,
                'netG': 'resnet_9blocks', 'net_gs': 'unet_512', 'ngf': 64,
                'norm': 'batch', 'padding': 'zero',
                'upsample': 'convtranspose', 'scale_size': TILE,
                'modalities_names': ['IHC', 'Hema', 'DAPI', 'Lap2', 'Marker'],
                'precision': 'float32'}


def write_flagship_model_dir(md, dl, net_gs='unet_512'):
    """DeepLIIFDef() defaults (with ``net_gs`` seg nets) in the native npz
    layout, weights at the reference init drawn from a numpy seed."""
    d = dl.DeepLIIFDef(net_g=(FLAGSHIP_CFG['netG'],) * 4,
                       net_gs=(net_gs,) * 5, ngf=FLAGSHIP_CFG['ngf'])
    write_model_dir(md, dl.DeepLIIFNets(d), dict(
        FLAGSHIP_CFG, net_gs=net_gs, seg_weights=list(d.seg_weights)))


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
    FR, FS, L, LB, C = K
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
            'label_components': LB.label_components.launches,
            'conv_s8': C.conv_s8.launches,
            # the dynamic scales' max pass of conv_s8
            's8_absmax': C.sample_absmax.launches,
            # int8 conv inputs not channels_last, copied to NHWC first
            'int8_relayouts': L.int8_input.relayouts}


def reset_counts(K):
    FR, FS, L, LB, C = K
    FR.conv3x3_stats.launches = 0
    FR.conv3x3_stats.launches_bf16 = 0
    FR.conv3x3_stats_int8.launches = 0
    FS.conv3x3_s2_stats.launches = 0
    FS.convtranspose3_s2_stats.launches = 0
    FS.tail_s2d_fused.launches = 0
    FS.tail_s2d_block.launches = 0
    L.plane_mean_var.launches = L.plane_mean_var.relayouts = 0
    LB.label_components.launches = 0
    C.conv_s8.launches = L.int8_input.relayouts = 0
    C.sample_absmax.launches = 0


def expected_counts(precision, fused, n_forwards, quant_calls=0, s8=0,
                    s8_dynamic=False):
    """Launches of each kernel per main-path run: the trunk kernel of the
    precision, the stage and tail kernels on the fused path only, the
    statistics kernel once per norm (no norm input copied first), the
    labeling kernel twice per device-quantifier call, ``s8`` conv_s8
    launches per forward (int8 scope 'all' only; no int8 input copied),
    each with its max pass where the scales are dynamic."""
    want = {kind: 0 for kind in ('float32', 'bfloat16', 'int8')}
    want[precision] = LAUNCHES_PER_FORWARD
    for name in ('conv3x3_s2_stats', 'convtranspose3_s2_stats'):
        want[name] = STAGE_LAUNCHES_PER_FORWARD if fused else 0
    want['tail_s2d'] = TAIL_LAUNCHES_PER_FORWARD if fused else 0
    want['plane_stats'] = PLANE_PER_FORWARD[fused]
    want['plane_relayouts'] = 0
    want['conv_s8'] = s8
    want['s8_absmax'] = s8 if s8_dynamic else 0
    want['int8_relayouts'] = 0
    want = {k: v * n_forwards for k, v in want.items()}
    want['label_components'] = LABEL_PER_QUANT * quant_calls
    return want


# phase 'pipeline': 40 tiles, four of them empty, so that the pipelined
# run_tiles call runs three batches, the last one short (16, 16 and 4 at
# BATCH 16)
PIPE_TILES, PIPE_EMPTY = 40, (5, 17, 30, 39)
# the host's waits on the device (utils.profiling.Trace.host_syncs) that a
# pipelined run_tiles needs from one batch's launch to the next: none
# before the second launch; then one, the event wait that collects the
# batch before; from the last launch to the end two collects and the
# trace's own closing cudaDeviceSynchronize. None inside a forward.
PIPE_SYNCS_FIRST, PIPE_SYNCS_MIDDLE, PIPE_SYNCS_LAST = 0, 1, 3
# phase 'batch_invariance': tile counts held against the same tiles in a
# batch of BATCH
INVARIANCE_COUNTS = (1, 2, 4, 8, 9)
# the profiler range around each batch forward (``batches_run``)
FORWARD_RANGE = 'InferenceSession.forward'


def run_u8(session, tiles, **kw):
    """``run_tiles``' outputs as one dict of host arrays (the device-kept GS
    fetched after the call)."""
    out = session.run_tiles(tiles, **kw)
    if isinstance(out, tuple):
        host, dev = out
        out = {**host, **{k: v.cpu().numpy() for k, v in dev.items()}}
    return out


@contextlib.contextmanager
def batches_run(session):
    """The batch size of each forward that ``session`` runs in the block
    (its bucket probes, ``raw=True``, left out), each forward inside the
    profiler range FORWARD_RANGE."""
    from torch.profiler import record_function
    sizes, run, own = [], session.forward, 'forward' in vars(session)

    def forward(tiles, *a, **k):
        if not k.get('raw'):
            sizes.append(int(tiles.shape[0]))
        with record_function(FORWARD_RANGE):
            return run(tiles, *a, **k)
    session.forward = forward
    try:
        yield sizes
    finally:
        if own:
            session.forward = run
        else:
            del session.forward


def padded_calls(keys):
    """{'kind dtype': count} of a bucket's padded library calls."""
    out = {}
    for k in keys:
        out[f'{k[0]} {k[3]}'] = out.get(f'{k[0]} {k[3]}', 0) + 1
    return out


def bucket_probes(session):
    """The session's bucket probes as a list of records, the padded
    library calls counted by kind and dtype."""
    return [{'tile': list(shape), 'path': {k: v for k, v in path},
             'bucket': b, **p, 'padded': padded_calls(p['padded'])}
            for (shape, path), probes in session.bucket_probes.items()
            for b, p in probes.items()]


def batch_invariance_checks(session, batch, path, **kw):
    """Phase 'batch_invariance': INVARIANCE_COUNTS tiles of ``batch`` (one
    alone, 2, 4, 8, 9) against the same tiles in the batch of BATCH,
    byte-equal (hard); the batch each call ran, and the buckets the
    session's probes refused, with the outputs that differed."""
    full = run_u8(session, batch, **kw)
    j, ran, inv = 3, {}, {}
    for n in INVARIANCE_COUNTS:
        with batches_run(session) as sizes:
            part = run_u8(session, batch[j:j + n], **kw)
        ran[n] = sizes
        inv[n] = {k: bool(np.array_equal(full[k][j:j + n], part[k]))
                  for k in full}
    probes = bucket_probes(session)
    ok = all(all(v.values()) for v in inv.values())
    phase('batch_invariance', path=path, byte_equal=ok,
          tiles_vs_in_batch=inv, batch_ran=ran,
          refused=[p for p in probes if not p['holds']], probes=probes)
    check(ok, f'{path}: tiles alone or in small batches differ from the '
              f'same tiles in a batch of {BATCH}: {inv}')
    return ran


def one_tile_ms(session, tile, **kw):
    """Median ms of three lone-tile ``run_tiles`` calls, and the batch it
    ran."""
    ms = []
    for _ in range(3):
        with batches_run(session) as sizes:
            t0 = time.perf_counter()
            run_u8(session, tile, **kw)
            ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), sizes


def pipeline_tiles(img):
    tiles = crops(img, PIPE_TILES, SEED + 2)
    tiles[list(PIPE_EMPTY)] = 128
    return tiles


def pipeline_checks(session, tiles, path, **kw):
    """Phase 'pipeline': ``tiles`` (PIPE_TILES, some empty) in one
    ``run_tiles`` call, whose batches are pipelined two deep, against the
    same tiles run BATCH at a time through separate calls (byte-equal,
    hard); one call traced with ``utils.profiling``: the host's waits on
    the device inside each forward (none allowed) and in each window from
    one batch's launch to the next (PIPE_SYNCS_*), and the share of the
    call the device was idle; the call's wall ms beside the separate
    calls' sum."""
    from deepliif_tpu_torch.utils import profiling as P
    # warm already: ``batch_invariance_checks`` probed the buckets and
    # allocated the host buffers of a batch of BATCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    separate = [run_u8(session, tiles[i:i + BATCH], **kw)
                for i in range(0, len(tiles), BATCH)]
    torch.cuda.synchronize()
    separate_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got = run_u8(session, tiles, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with batches_run(session) as sizes, P.trace() as tr:
        traced = session.run_tiles(tiles, **kw)
    if isinstance(traced, tuple):
        traced = {**traced[0], **{k: v.cpu().numpy()
                                  for k, v in traced[1].items()}}
    equal = {k: bool(np.array_equal(got[k], np.concatenate(
        [s_[k] for s_ in separate])) and np.array_equal(got[k], traced[k]))
        for k in got}
    spans = tr.spans(FORWARD_RANGE)
    check(spans and tr.device_events(), f'{path}: the pipeline trace saw no '
                                        'forward or no device activity')
    starts = [a for a, _ in spans] + [tr.window[1]]
    in_forward = [tr.host_syncs(a, b) for a, b in spans]
    per_window = [tr.host_syncs(starts[i], starts[i + 1])
                  for i in range(len(spans))]
    allowed = [PIPE_SYNCS_FIRST] + [PIPE_SYNCS_MIDDLE] * (len(spans) - 2) \
        + [PIPE_SYNCS_LAST]
    syncs_ok = (not any(in_forward) and all(
        sum(w.values()) <= a for w, a in zip(per_window, allowed)))
    phase('pipeline', path=path, tiles=len(tiles),
          empty=len(PIPE_EMPTY), batches=sizes, wall_ms=wall_ms,
          separate_calls_ms=separate_ms,
          traced_wall_ms=(tr.window[1] - tr.window[0]) / 1e3,
          device_busy_ms=tr.busy_ms(), idle_share=tr.idle_share(),
          idle_share_from_first_launch=tr.idle_share(starts[0],
                                                     tr.window[1]),
          host_syncs=tr.host_syncs(), host_syncs_in_forward=in_forward,
          host_syncs_per_window=per_window, allowed_per_window=allowed,
          sync_sites_in_forward=[tr.sync_sites(a, b) for a, b in spans],
          byte_equal=equal)
    check(all(equal.values()), f'{path}: the pipelined call differs from '
                               f'the same tiles {BATCH} at a time: {equal}')
    check(len(sizes) == 3, f'{path}: batches {sizes}, want three')
    check(syncs_ok, f'{path}: host waits in forwards {in_forward}, per '
                    f'window {per_window}, allowed {allowed}')
    return dict(wall_ms=wall_ms, separate_calls_ms=separate_ms,
                idle_share=tr.idle_share(), batches=sizes)


def throughput(session, batch, iters=1, **kw):
    session.run_tiles(batch, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        session.run_tiles(batch, **kw)
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
                   int8={}, fuse_stages=False):
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

    # batch invariance of the whole path: tiles alone and in small
    # buckets vs in a batch; then the batch pipeline
    batch_invariance_checks(session, batch, path)
    pipe = pipeline_checks(session, pipeline_tiles(img), path)

    tput = throughput(session, batch)
    tput['one_tile_ms'], tput['one_tile_batch'] = one_tile_ms(session,
                                                              batch[3:4])
    tput['pipeline'] = pipe
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
    background flood; on a seg canvas most pixels are unknown and nearly all
    of them are one background component that spans the canvas) and, after
    the flood, the cell mask (conn 8; small components, the cells)."""
    mask = LB.posneg_mask(seg, 120)
    return {4: mask == LB.LABEL_UNKNOWN,
            8: LB.flood_background(mask) != LB.LABEL_BACKGROUND}


def adversarial_masks(h, w, seed):
    """Masks (h, w) bool (numpy) that stress a tiled labeling at its tile
    borders:
    - serpentine: every other row foreground, joined at alternate ends: one
      path that crosses every vertical tile border on each of its rows;
    - comb: a spine on the top row, a tooth of random length down every
      other column, crossing horizontal tile borders at any offset;
    - checkerboard: all singletons at conn 4, one component at conn 8;
    - diagonals: lines that pass from tile to tile only through corners
      (joined at conn 8 only) and anti-diagonals crossing them;
    - percolation: random fill at 0.6, near conn 4's percolation threshold,
      so its components are large and tortuous."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    serp = yy % 2 == 0
    serp[1::4, -1] = True
    serp[3::4, 0] = True
    comb = np.zeros((h, w), bool)
    comb[0] = True
    teeth = rng.integers(1, h + 1, w)
    comb |= (xx % 2 == 0) & (yy < teeth[None, :])
    return {'serpentine': serp, 'comb': comb,
            'checkerboard': (yy + xx) % 2 == 0,
            'diagonals': ((xx - yy) % 9 == 0) | ((xx + yy) % 13 == 0),
            'percolation': rng.random((h, w)) < 0.6}


def kernel_checks_label(LB, canvases):
    """label_components at conn 4 and 8 on the masks of each canvas:
    bit-equal to the plain labeling, byte-equal run to run, timed in turns
    against it. The bound: the mask read once (1 B/px) and the labels
    written once (4 B/px) over HBM. Then the adversarial masks at
    LABEL_ADVERSARIAL_SHAPES (bit-equal to the plain labeling, byte-equal
    run to run) and the worst case at the largest canvas (label_worst_case).
    Returns {(h, w, conn): numbers, 'worst': {conn: numbers}}."""
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
                  bound_by='bytes', bound_share=bound_ms / ms['kernel'],
                  library_call='none: PyTorch has no connected-components '
                               'call')
            out[(h, w, conn)] = dict(err=err, ms=ms['kernel'],
                                     plain_ms=ms['plain'], bound_ms=bound_ms)
            torch.cuda.empty_cache()
    for h, w in LABEL_ADVERSARIAL_SHAPES:
        for name, m in adversarial_masks(h, w, SEED).items():
            fg = torch.from_numpy(m).cuda()
            for conn in (4, 8):
                got = LB.label_components(fg, conn8=conn == 8)
                want = LB.label_components_reference(fg, conn8=conn == 8)
                again = LB.label_components(fg, conn8=conn == 8)
                err = (got.long() - want.long()).abs().max().item()
                same = bool(torch.equal(got, again))
                phase('kernel_vs_plain', kernel='label_components', mask=name,
                      canvas=[h, w], conn=conn, bit_equal=err == 0,
                      max_abs_err=err, two_launches_byte_equal=same)
                check(err == 0, f'label_components {name} {h}x{w} conn '
                                f'{conn}: labels differ from the plain '
                                f'labeling by {err}')
                check(same, f'label_components {name} {h}x{w} conn {conn}: '
                            'two launches differ')
                out[(name, h, w, conn)] = dict(err=err)
            del fg, got, want, again
    out['worst'] = label_worst_case(LB, *QUANT_CANVASES[-1])
    torch.cuda.empty_cache()
    return out


def scipy_canonical_labels(mask, conn8, device):
    """scipy.ndimage.label of the (h, w) numpy mask on the host, renumbered
    to the canonical labels (the minimum flat index of each component + 1,
    taken on ``device``): an independent labeling to hold the kernel to."""
    from scipy import ndimage
    lab, n = ndimage.label(mask, structure=np.ones((3, 3), int) if conn8
                           else None)
    flat = torch.from_numpy(lab.astype(np.int64).reshape(-1)).to(device)
    first = torch.full((n + 1,), mask.size, dtype=torch.int64, device=device
                       ).scatter_reduce_(0, flat, torch.arange(
                           flat.numel(), device=device), 'amin')
    return torch.where(flat > 0, first[flat] + 1, 0).to(
        torch.int32).reshape(mask.shape)


def label_worst_case(LB, h, w):
    """The kernel's worst case (LABEL_WORST_CASE) at (h, w), conn 4 and 8:
    byte-equal run to run, equal to scipy's labels renumbered canonically,
    timed (5 launches) beside its byte bound."""
    m = adversarial_masks(h, w, SEED)[LABEL_WORST_CASE]
    fg = torch.from_numpy(m).cuda()
    out = {}
    for conn in (4, 8):
        got = LB.label_components(fg, conn8=conn == 8)
        again = LB.label_components(fg, conn8=conn == 8)
        same = bool(torch.equal(got, again))
        want = scipy_canonical_labels(m, conn == 8, fg.device)
        equal = bool(torch.equal(got, want))
        del got, again, want
        ms = cuda_ms(lambda: LB.label_components(fg, conn8=conn == 8), 5)
        bound_ms = h * w * (1 + 4) / PEAK_BYTES * 1e3
        phase('kernel_worst_case', kernel='label_components',
              mask=LABEL_WORST_CASE, canvas=[h, w], conn=conn,
              fg_share=float(m.mean()), equal_to_scipy=equal,
              two_launches_byte_equal=same, ms=ms, bound_ms=bound_ms,
              bound_share=bound_ms / ms)
        check(equal, f'label_components {LABEL_WORST_CASE} {h}x{w} conn '
                     f'{conn}: labels differ from scipy\'s')
        check(same, f'label_components {LABEL_WORST_CASE} {h}x{w} conn '
                    f'{conn}: two launches differ')
        out[conn] = dict(ms=ms, bound_ms=bound_ms)
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


LABEL_KERNELS = ('local_kernel', 'border_kernel', 'resolve_kernel')


def devquant_breakdown(LB, canvas):
    """One device-quantifier call (thresholds 'default') on the largest
    canvas traced with torch.profiler, after a warm-up call: device time by
    op (top 10, self time of each torch op, the labeling kernels as one op
    'label_components') and by kernel (top 10), the labeling kernels' share,
    the device's busy time (the union of its kernels, copies and fills)
    against the host's wall time, and the device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def labeler(fg, conn8=True):
        with record_function('label_components'):
            return LB.label_components(fg, conn8=conn8)

    (h, w), (orig, seg, marker) = canvas
    orig_np, marker_np = orig.cpu().numpy(), marker.cpu().numpy()

    def call():
        return LB.compute_final_results_device(
            orig_np, seg, marker_np, '40x', size_thresh='default',
            marker_thresh='default', labeler=labeler)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev, 'devquant_breakdown: the profiler saw no device activity')

    def ms(e):
        return (e.time_range.end - e.time_range.start) / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, -1.0
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    device_ms = sum(ms(e) for e in dev)
    by_kernel = {}
    for e in dev:
        name = e.name[:90]
        by_kernel[name] = by_kernel.get(name, 0.0) + ms(e)
    label_ms = sum(ms(e) for e in dev
                   if any(k in e.name for k in LABEL_KERNELS))
    by_op = {'label_components': label_ms}
    for ev in prof.key_averages():
        self_us = getattr(ev, 'self_device_time_total', 0)
        if ev.key != 'label_components' and self_us > 0 and \
                ev.device_type == torch.autograd.DeviceType.CPU:
            by_op[ev.key] = by_op.get(ev.key, 0.0) + self_us / 1e3
    d2h = [e for e in dev if 'DtoH' in e.name or 'Device -> Pageable' in
           e.name or 'Device -> Pinned' in e.name]

    def top(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:10])
    res = dict(canvas=[h, w], host_wall_ms=wall_ms,
               device_busy_ms=busy_us / 1e3,
               device_busy_share=busy_us / 1e3 / wall_ms,
               device_ms_summed=device_ms, device_events=len(dev),
               labeling_ms=label_ms,
               labeling_share_of_device=label_ms / device_ms,
               labeling_share_of_wall=label_ms / wall_ms,
               d2h_copies=len(d2h), d2h_ms=sum(ms(e) for e in d2h),
               top_ops_ms=top(by_op), top_kernels_ms=top(by_kernel))
    phase('devquant_breakdown', **res)
    return res


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

    # the engine with the seg kept on the card, as this path runs it
    path = 'float32 device_quant'
    batch_invariance_checks(session, crops(img, BATCH, SEED + 1), path,
                            device_keys=('GS',))
    pipeline_checks(session, pipeline_tiles(img), path, device_keys=('GS',))
    return counts


def s8_macs(kind, shape, cout, k, op):
    """(output shape, multiply-adds that this call needs): the taps that
    land inside the input only (conv padding and the conv-transpose's
    dilation zeros need none), counted per axis."""
    n, h, w, cin = shape
    lo = k - 1 - 1 if kind == 'convT' else 1   # padding 1 throughout

    def axis(size):
        if kind == 'conv':
            out = (size + 2 - k) // 2 + 1
            taps = sum(0 <= o * 2 - lo + t < size
                       for o in range(out) for t in range(k))
        else:
            out = (size - 1) * 2 - 2 + k + op
            taps = sum((o + t - lo) % 2 == 0 and 0 <= (o + t - lo) // 2 < size
                       for o in range(out) for t in range(k))
        return out, taps
    (ho, ty), (wo, tx) = axis(h), axis(w)
    return (n, ho, wo, cout), n * ty * tx * cin * cout


def s8_bound(kind, shape, cout, k, op, dynamic=False):
    """Least time (ms) of one conv_s8 call and what bounds it: 2 ops per
    needed multiply-add at the int8 tensor-core peak, or the bytes moved
    once over HBM: x read as bf16 (dynamic scales: twice, the max pass and
    the conv), the int8 weights and their f32 scales, the bf16 y."""
    out, macs = s8_macs(kind, shape, cout, k, op)
    nx = int(np.prod(shape))
    nbytes = 2 * nx * (2 if dynamic else 1) + k * k * shape[3] * cout \
        + 4 * cout + 2 * int(np.prod(out))
    t_ops, t_bytes = 2.0 * macs / PEAK_OPS['int8'], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes'), macs


def s8_call(C, kind, op, reference=False):
    """(x, qc) -> the call's output through the fused entry (the kernel on
    the card) or its plain version."""
    if kind == 'conv':
        fn = C.conv2d_s8_reference if reference else C.conv2d_s8
        return lambda x, qc: fn(x, qc, None, 2, 1)
    fn = (C.conv_transpose2d_s8_reference if reference
          else C.conv_transpose2d_s8)
    return lambda x, qc: fn(x, qc, None, 2, 1, op)


def s8_conv_params(rnd, x, kind, k, cout):
    """The static and dynamic Int8Conv of an N(0, 0.02) conv whose input is
    x: static scales calibrated as the session does (max |x| per input
    channel), the weights packed once."""
    from deepliif_tpu_torch.ops import quant
    w = rnd(k, k, x.shape[3], cout, std=0.02)
    scale = x.float().abs().amax(dim=(0, 1, 2)).cpu().tolist()
    return {mode: quant.quantize_conv(w, w, scale if mode == 'static'
                                      else None, torch.bfloat16)
            for mode in ('static', 'dynamic')}


def kernel_checks_conv_s8(C, rnd):
    """conv_s8 (the bf16 input quantized in the load) at every call of the
    int8 'all' flagship forward (S8_CALLS), with static (per input channel)
    and dynamic (per sample, after the max pass) scales: bit-equal to its
    plain version (torch's quantize, a float64 conv, the epilogue),
    byte-equal run to run and for a sample alone against the same sample
    in the batch; each call's kernel time, static and dynamic, against its
    bound; the max pass timed at each call; the largest call (S8_TIMED)
    timed in turns against its plain version, against torch._int_mm on the
    im2col'd quantized operands (the same int32 sums; F.unfold and the
    quantize not counted) and against cuDNN's bf16 conv of the same shape
    (another function: a bf16 conv, no quantization)."""
    import torch.nn.functional as F

    out, per_call, worst = {}, {}, 0.0
    for name, kind, shape, cout, k, op in S8_CALLS:
        x = rnd.big(*shape)
        qcs = s8_conv_params(rnd, x, kind, k, cout)
        run, plain = s8_call(C, kind, op), s8_call(C, kind, op, True)
        res, rec = {}, {}
        for mode, qc in qcs.items():
            y = run(x, qc)
            want = plain(x, qc)
            alone = run(x[3:4].contiguous(), qc)
            res[mode] = dict(bit_equal=torch.equal(y, want),
                             run_to_run=torch.equal(y, run(x, qc)),
                             alone_vs_batch=torch.equal(alone[0], y[3]))
            worst = max(worst, (y.float() - want.float()).abs().max().item())
            del y, want, alone
            ms = cuda_ms(lambda qc=qc: run(x, qc), 3)
            b_ms, b_by, macs = s8_bound(kind, shape, cout, k, op,
                                        mode == 'dynamic')
            rec[mode] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                             bound_share=b_ms / ms,
                             tops=2.0 * macs / ms / 1e9)
        rec['absmax_ms'] = cuda_ms(lambda: C.sample_absmax(x), 3)
        per_call[name] = rec
        phase('kernel_vs_plain', kernel='conv_s8', call=name, kind=kind,
              x=list(shape), cout=cout, k=k, output_padding=op, **res,
              **{f'{m}_{k_}': v for m in ('static', 'dynamic')
                 for k_, v in rec[m].items()}, absmax_ms=rec['absmax_ms'])
        check(all(all(v.values()) for v in res.values()),
              f'conv_s8 {name}: kernel vs plain / run to run / alone vs '
              f'batch: {res}')
        if name == S8_TIMED:
            out['timed'] = timed_conv_s8(C, F, x, qcs['static'], kind, shape,
                                         cout, k, op)
        del x, qcs
        torch.cuda.empty_cache()
    n_calls = {name: S8_NETS[name.split()[0]] for name, *_ in S8_CALLS}
    dyn = [nm for nm in per_call if nm != 'translator down0']

    def total(names, mode, key):
        return sum(per_call[nm][mode][key] * n_calls[nm] for nm in names)
    out.update(
        per_call=per_call, err=worst,
        forward_ms={'static': total(per_call, 'static', 'ms'),
                    'dynamic': total(dyn, 'dynamic', 'ms')},
        forward_bound_ms={'static': total(per_call, 'static', 'bound_ms'),
                          'dynamic': total(dyn, 'dynamic', 'bound_ms')},
        absmax_forward_ms=sum(per_call[nm]['absmax_ms'] * n_calls[nm]
                              for nm in dyn))
    phase('kernel_timing', kernel='conv_s8', what='the calls of one batch-16 '
          'forward, summed (kernel time, the quantize and, dynamic, the max '
          'pass included)', **{
              f'forward_{k}': v for k, v in out['forward_ms'].items()},
          **{f'forward_bound_{k}': v
             for k, v in out['forward_bound_ms'].items()},
          absmax_forward_ms=out['absmax_forward_ms'])
    return out


def timed_conv_s8(C, F, x, qc, kind, shape, cout, k, op):
    run, plain = s8_call(C, kind, op), s8_call(C, kind, op, True)
    xb = x.permute(0, 3, 1, 2)                       # channels_last memory
    wb = qc.w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    xq, _ = C.quantize_reference(x, qc)
    cols = F.unfold(xq.permute(0, 3, 1, 2).to(torch.float16), k, padding=1,
                    stride=2)                        # (N, Cin k k, L)
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(
        torch.int8).contiguous()
    b = qc.w_q.permute(2, 0, 1, 3).reshape(-1, cout).contiguous()
    fns = {'plain': lambda: plain(x, qc), 'kernel': lambda: run(x, qc),
           'cudnn_bf16': lambda: F.conv2d(xb, wb, None, 2, 1)}
    library_error = None
    for bb in (b, b.t().contiguous().t()):      # row-, then column-major B
        try:
            torch._int_mm(a, bb)
        except RuntimeError as e:
            library_error = str(e)[:200]
            continue
        fns['library'] = lambda bb=bb: torch._int_mm(a, bb)
        library_error = None
        break
    runs, ms = in_turns(fns, {'plain': 1, 'kernel': 5, 'library': 5,
                              'cudnn_bf16': 5})
    ms.setdefault('library', None)
    b_ms, b_by, macs = s8_bound(kind, shape, cout, k, op)
    phase('kernel_timing', kernel='conv_s8', call=S8_TIMED, x=list(shape),
          cout=cout, runs_ms=runs, **{f'{k_}_ms': v for k_, v in ms.items()},
          library_error=library_error,
          tops=2.0 * macs / ms['kernel'] / 1e9,
          bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms['kernel'],
          library_call='torch._int_mm on the im2col\'d quantized operands '
                       '(the int32 sums alone: no quantize, no epilogue; '
                       'F.unfold not counted)',
          cudnn_bf16_call='F.conv2d of the same shape in bf16, channels_last '
                          '(a different function: no quantization)')
    del cols, a, b, xb, xq
    return dict(ms, bound_ms=b_ms, bound_by=b_by)


def int8_all_breakdown(session, batch):
    """One batch-16 forward of the int8 'all' session traced with
    torch.profiler after a warm-up: device time by kernel (top 12), the
    conv_s8 (its quantize included) and trunk-kernel totals, the count and
    device time of torch's own kernels (``at::native``: elementwise passes,
    copies, reductions; the elementwise ones apart), and the device's busy
    time against the host's wall time."""
    from torch.profiler import ProfilerActivity, profile

    tiles = torch.from_numpy(batch)
    session.forward(tiles)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.forward(tiles)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev, 'int8_all_breakdown: the profiler saw no device activity')

    def ms(e):
        return (e.time_range.end - e.time_range.start) / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, -1.0
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_kernel, n_by_kernel = {}, {}
    for e in dev:
        by_kernel[e.name[:90]] = by_kernel.get(e.name[:90], 0.0) + ms(e)
        n_by_kernel[e.name[:90]] = n_by_kernel.get(e.name[:90], 0) + 1
    total = sum(by_kernel.values())

    def share(pred):
        return sum(v for k, v in by_kernel.items() if pred(k))

    def count(pred):
        return sum(v for k, v in n_by_kernel.items() if pred(k))
    trunk = ('conv_wgmma_kernel', 'quantize_blocks', 'chunk_max',
             'row_absmax', 'pack_weights', 'stats_reduce')
    native = lambda k: 'at::native' in k                       # noqa: E731
    elementwise = lambda k: native(k) and 'elementwise' in k   # noqa: E731
    s8 = lambda k: 'conv_s8' in k                              # noqa: E731
    groups = {
        'conv_s8 (quantize, conv, max pass, split epilogue)': share(s8),
        'trunk kernel #2 (all its passes)': share(
            lambda k: any(t in k for t in trunk)),
        'plane_stats': share(lambda k: 'plane_' in k),
        'cuDNN convs': share(lambda k: any(
            t in k for t in ('xmma', 'cudnn', 'cutlass', 'implicit_gemm'))),
        'torch elementwise and copies (norm affine, ReLU, residual adds, '
        'concatenations, casts)': share(native)}
    groups['other'] = total - sum(groups.values())
    res = dict(batch=len(batch), host_wall_ms=wall_ms,
               device_busy_ms=busy_us / 1e3,
               device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
               device_ms_summed=total, groups_ms=groups,
               conv_s8_launches=count(s8),
               torch_native_launches=count(native),
               torch_native_ms=share(native),
               torch_elementwise_launches=count(elementwise),
               torch_elementwise_ms=share(elementwise),
               device_launches=len(dev),
               top_kernels_ms=dict(sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1])[:12]))
    phase('int8_all_breakdown', **res)
    return res


def int8_all_checks(M, K, md, img, f32_images, mode):
    """int8 scope 'all' (no --int8-scope: the JAX package's default) through
    the user entry point at full width: ``mode`` 'static' calibrates on the
    first tiles (its seconds and keys, act_scales.json in the model dir),
    'dynamic' runs with calibration off. The launch counts (conv_s8 per
    S8_PER_FORWARD, the trunk's #2, no float trunk kernel, no input or norm
    input copied; calibration: only the statistics of its float replay),
    the conv_s8 calls against S8_CALLS, run to run, one translator with
    conv_s8 swapped for its plain version (byte-equal), device_quant on,
    batch invariance, tiles/s and the uint8 distance to the float32
    path."""
    FR, FS, L, LB, C = K
    static = mode == 'static'
    path = f'int8_all {mode}'
    kw = dict(device='cuda', max_batch=BATCH, precision='int8',
              int8_calibrate=static)
    t0 = time.perf_counter()
    session = M.init_nets(md, **kw)
    phase('session', path=path, seconds=time.perf_counter() - t0,
          int8_scope=session.int8_scope,
          act_scales_file=session.act_scales is not None,
          quantized_convs={'translator': len(session.nets.G[0].int8),
                           'unet_512': len(session.nets.GS[0].int8)})
    check(session.int8_scope == 'all' and session.act_scales is None,
          f'{path}: scope {session.int8_scope}, act_scales before the run')
    forwards, calib = [], {}
    run_batch, run_calib = session.forward, session.calibrate_int8
    session.forward = lambda *a, **k: forwards.append(1) or run_batch(*a, **k)

    def calibrate(tiles, **k):
        torch.cuda.synchronize()
        before, t = launch_counts(K), time.perf_counter()
        scales = run_calib(tiles, **k)
        torch.cuda.synchronize()
        after = launch_counts(K)
        calib.update(seconds=time.perf_counter() - t, tiles=len(tiles),
                     keys=len(scales), launches={
                         k_: after[k_] - before[k_] for k_ in after})
        return scales
    session.calibrate_int8 = calibrate

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
          kernel_launches=counts, outputs=sorted(images), scoring=scoring,
          trunk_modes=[g.int8_mode for g in session.nets.G])
    check(n_forwards >= 1, 'no batch forward ran')
    check(all(g.int8_mode == mode for g in session.nets.G),
          f'{path}: trunk modes {[g.int8_mode for g in session.nets.G]}')
    want = expected_counts('int8', False, n_forwards,
                           s8=S8_PER_FORWARD[mode], s8_dynamic=not static)
    if static:
        batches = -(-calib.get('tiles', 0) // CALIB_BATCH)
        phase('calibration', path=path, seconds=calib.get('seconds'),
              tiles=calib.get('tiles'), batches=batches,
              keys=calib.get('keys'), launches=calib.get('launches'),
              act_scales_json=os.path.exists(os.path.join(md,
                                                          'act_scales.json')))
        cl = calib.get('launches', {})
        check(calib and calib['keys'] == CALIB_KEYS
              and cl['plane_stats'] == batches * CALIB_PLANE_PER_BATCH
              and all(v == 0 for k, v in cl.items() if k != 'plane_stats')
              and os.path.exists(os.path.join(md, 'act_scales.json')),
              f'{path}: calibration {calib}')
        want['plane_stats'] += cl['plane_stats']
    else:
        check(not calib, f'{path}: calibrated with calibration off')
    check(counts == want, f'{path}: kernel launches {counts} for '
                          f'{n_forwards} forwards, want {want}')
    check(set(images) == OUTPUTS, f'outputs {sorted(images)}')
    for k, im in images.items():
        a = np.asarray(im)
        check(a.shape == (2 * TILE, 2 * TILE, 3) and a.dtype == np.uint8,
              f'{k}: {a.shape} {a.dtype}')

    images2, scoring2 = M.infer_modalities(img, TILE, md, device_quant=False,
                                           **kw)
    same = all(np.array_equal(np.asarray(images[k]), np.asarray(images2[k]))
               for k in images) and scoring == scoring2
    phase('run_to_run', path=path, byte_equal=same)
    check(same, f'{path}: two runs differ')

    rng = np.random.default_rng(SEED + 1)
    big = np.asarray(img)
    origins = rng.integers(0, 2 * TILE - TILE + 1, (BATCH, 2))
    batch = np.stack([big[y:y + TILE, x:x + TILE] for y, x in origins])

    # the conv_s8 calls of one forward against S8_CALLS
    calls, kernel = [], C.conv_s8

    def spy(x, qc, bias, **k):
        calls.append((tuple(x.shape), tuple(qc.w_q.shape), k['stride'],
                      k['dil']))
        return kernel(x, qc, bias, **k)
    spy.launches = 0
    C.conv_s8 = spy
    try:
        with torch.no_grad():
            run_batch(torch.from_numpy(batch))
    finally:
        C.conv_s8 = kernel
    want_calls = sorted(
        (shape, (k, k, shape[3], cout), 2 if kind == 'conv' else 1,
         1 if kind == 'conv' else 2)
        for name, kind, shape, cout, k, _ in S8_CALLS
        for _ in range(S8_NETS[name.split()[0]])
        if static or name != 'translator down0')
    phase('conv_s8_calls', path=path, calls=len(calls),
          distinct=len(set(calls)), match=sorted(calls) == want_calls)
    check(sorted(calls) == want_calls,
          f'{path}: conv_s8 calls {sorted(set(calls))} differ from '
          f'S8_CALLS')

    # one translator with conv_s8 swapped for its plain version: the int8
    # convs are bit-equal, so the translator is byte-equal
    net = session.nets.G[0]
    xin = (torch.from_numpy(batch[:2]).cuda().float() / 127.5 - 1.0).permute(
        0, 3, 1, 2).to(session.d.dtype)
    conv, convt = C.conv2d_s8, C.conv_transpose2d_s8
    with torch.no_grad():
        got = net(xin)
        C.conv2d_s8 = C.conv2d_s8_reference
        C.conv_transpose2d_s8 = C.conv_transpose2d_s8_reference
        try:
            want_t = net(xin)
        finally:
            C.conv2d_s8, C.conv_transpose2d_s8 = conv, convt
    same = torch.equal(got, want_t)
    phase('translator_vs_plain_conv_s8', path=path, shape=list(got.shape),
          finite=bool(torch.isfinite(got).all()), byte_equal=same)
    check(same and bool(torch.isfinite(got).all()),
          f'{path}: the translator with conv_s8 differs from the same with '
          'its plain version')

    # device_quant on: the same Seg and modalities, the labeling kernel
    reset_counts(K)
    dq_images, dq_scoring = M.infer_modalities(img, TILE, md,
                                               device_quant=True, **kw)
    dq_counts = launch_counts(K)
    equal = all(np.array_equal(np.asarray(images[k]),
                               np.asarray(dq_images[k]))
                for k in images if k not in ('SegOverlaid', 'SegRefined'))
    phase('device_quant', path=path, label_launches=dq_counts[
        'label_components'], seg_and_modalities_byte_equal=equal,
        scoring=dq_scoring, host_scoring=scoring)
    check(equal and dq_counts['label_components'] == LABEL_PER_QUANT
          and dq_scoring == scoring,
          f'{path}: device_quant run: {dq_counts}, {dq_scoring} vs '
          f'{scoring}')

    batch_invariance_checks(session, batch, path)
    pipe = pipeline_checks(session, pipeline_tiles(img), path)

    tput = throughput(session, batch)
    tput['one_tile_ms'], tput['one_tile_batch'] = one_tile_ms(session,
                                                              batch[3:4])
    tput['pipeline'] = pipe
    dist = u8_distance(images, f32_images)
    phase('throughput', path=path, **tput)
    phase('vs_float32', path=path, mean_lsb_and_share_within_2=dist)
    xb = (torch.from_numpy(batch).cuda().float() / 127.5 - 1.0).permute(
        0, 3, 1, 2).to(session.d.dtype)
    with torch.no_grad():
        ms = {'translator': cuda_ms(lambda: net(xb), 2),
              'translator_trunk': cuda_ms(lambda: net.trunk(net.head(xb)), 2),
              'seg_unet_512': cuda_ms(lambda: session.nets.GS[0](xb), 2)}
    phase('per_net_ms', path=path, batch=BATCH, **ms,
          ensemble_estimate_ms=4 * ms['translator'] + 5 * ms['seg_unet_512'])
    breakdown = int8_all_breakdown(session, batch) if static else None
    del session.forward, session.calibrate_int8   # the class's methods again
    if static:
        os.remove(os.path.join(md, 'act_scales.json'))
    return dict(counts=counts, tput=tput, calib=calib, vs_float32=dist,
                breakdown=breakdown, per_net_ms=ms)


def crops(img, n, seed):
    """``n`` random TILE^2 crops of ``img`` (PIL, 2 TILE square)."""
    rng = np.random.default_rng(seed)
    big = np.asarray(img)
    origins = rng.integers(0, big.shape[0] - TILE + 1, (n, 2))
    return np.stack([big[y:y + TILE, x:x + TILE] for y, x in origins])


@contextlib.contextmanager
def session_forwards(M):
    """Every ``InferenceSession.forward`` in the block, of sessions that
    entry points make inside it: a list of (batch, raw), raw the bucket
    probes' forwards."""
    calls, run = [], M.InferenceSession.forward

    def forward(self, tiles, *a, **k):
        calls.append((int(tiles.shape[0]), bool(k.get('raw'))))
        return run(self, tiles, *a, **k)
    M.InferenceSession.forward = forward
    try:
        yield calls
    finally:
        M.InferenceSession.forward = run


def count_forwards(session):
    """Wraps ``session.forward`` to count batch forwards; returns the list
    it appends to (``del session.forward`` restores the method)."""
    forwards = []
    run_batch = session.forward
    session.forward = lambda *a, **k: forwards.append(1) or run_batch(*a,
                                                                     **k)
    return forwards


def path_counts(trunk_kind, trunk, plane, n_forwards):
    """Launches per main-path run of a path with ``trunk`` trunk-kernel
    launches (of ``trunk_kind``) and ``plane`` statistics calls per batch
    forward, and no other kernel."""
    want = {k: 0 for k in ('float32', 'bfloat16', 'int8', 'conv3x3_s2_stats',
                           'convtranspose3_s2_stats', 'tail_s2d',
                           'plane_relayouts', 'label_components', 'conv_s8',
                           's8_absmax', 'int8_relayouts')}
    want[trunk_kind] = trunk * n_forwards
    want['plane_stats'] = plane * n_forwards
    return want


def seg_only_checks(M, K, md, img, precision):
    """Seg-only on the flagship session of ``precision`` (the cached one of
    ``slice_checks``) with the config's seg weights and the legacy ones:
    the main path through ``infer_modalities(seg_only=True)`` with its
    launch counts (18 trunk launches per translator run, 5 + 15 statistics
    calls per translator and seg net run), Seg and the marker byte-equal to
    the full forward's in the same session, and tiles/s beside the full
    forward's."""
    kw = dict(device='cuda', max_batch=BATCH, precision=precision,
              int8_scope=None, fuse_stages=False)
    session = M.init_nets(md, **kw)
    batch = crops(img, BATCH, SEED + 1)
    names = session.opt.modalities_names[1:]
    marker = f'G{names.index("Marker") + 1}'
    out = {}
    for label, weights in (('config', None), ('legacy', LEGACY_SEG_WEIGHTS)):
        w = session.d.seg_weights if weights is None else weights
        needed = [i for i in range(4) if w[i + 1] != 0]
        translators = len(set(needed) | {names.index('Marker')})
        seg_nets = len(needed) + (w[0] != 0)
        forwards = count_forwards(session)
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        images, scoring = M.infer_modalities(
            img, TILE, md, device_quant=False, seg_only=True,
            seg_weights=weights, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts(K)
        n = len(forwards)
        del session.forward
        want = path_counts(precision, TRUNK_PER_NET * translators,
                           PLANE_PER_TRANSLATOR * translators
                           + PLANE_PER_UNET * seg_nets, n)
        full = session.run_tiles(batch, seg_weights=weights)
        pruned = session.run_tiles(batch, seg_weights=weights, seg_only=True)
        equal = {k: bool(np.array_equal(pruned[k], full[k]))
                 for k in ('GS', marker)}
        t_full = throughput(session, batch, seg_weights=weights)
        t_pruned = throughput(session, batch, seg_weights=weights,
                              seg_only=True)
        phase('seg_only', precision=precision, weights=list(w),
              translators_run=translators, seg_nets_run=seg_nets,
              seconds=seconds, batch_forwards=n, kernel_launches=counts,
              outputs=sorted(images), scoring=scoring,
              byte_equal_to_full_forward=equal,
              tiles_per_s=t_pruned['tiles_per_s'],
              full_forward_tiles_per_s=t_full['tiles_per_s'],
              peak_mem_gib=t_pruned['peak_mem_gib'])
        check(n >= 1, 'seg-only: no batch forward ran')
        check(counts == want, f'seg-only {precision} {label}: kernel '
                              f'launches {counts} for {n} forwards, want '
                              f'{want}')
        check(set(images) == {'Seg', 'SegOverlaid', 'SegRefined'},
              f'seg-only outputs {sorted(images)}')
        check(all(equal.values()), f'seg-only {precision} {label}: not '
                                   f'byte-equal to the full forward {equal}')
        out[label] = dict(trunk=counts[precision] // n,
                          plane_stats=counts['plane_stats'] // n,
                          tiles_per_s=t_pruned['tiles_per_s'],
                          full_tiles_per_s=t_full['tiles_per_s'])
    return out


def seg_intermediate_checks(M, K, md, img):
    """The seg intermediates on the float32 flagship session: GS0..GS4
    present (named '{modality}_s' by ``infer_modalities``), GS byte-equal to
    the full forward's, the outputs byte-equal run to run, the launches of
    a full forward."""
    kw = dict(device='cuda', max_batch=BATCH, precision='float32',
              int8_scope=None, fuse_stages=False)
    session = M.init_nets(md, **kw)
    forwards = count_forwards(session)
    torch.cuda.synchronize()
    reset_counts(K)
    images, scoring = M.infer_modalities(img, TILE, md, device_quant=False,
                                         return_seg_intermediate=True, **kw)
    torch.cuda.synchronize()
    counts, n = launch_counts(K), len(forwards)
    del session.forward
    names = ['IHC', 'Hema', 'DAPI', 'Lap2', 'Marker']
    want_names = OUTPUTS | {f'mod{i}-{nm}_s' for i, nm in enumerate(names)}
    batch = crops(img, BATCH, SEED + 1)
    full = session.run_tiles(batch)
    runs = [session.run_tiles(batch, return_intermediate=True)
            for _ in range(2)]
    same = all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    gs_equal = bool(np.array_equal(runs[0]['GS'], full['GS']))
    want = path_counts('float32', 4 * TRUNK_PER_NET,
                       PLANE_PER_FORWARD[False], n)
    phase('seg_intermediate', outputs=sorted(images), batch_forwards=n,
          kernel_launches=counts, run_tiles_keys=sorted(runs[0]),
          gs_byte_equal_to_full_forward=gs_equal, run_to_run_byte_equal=same,
          scoring=scoring)
    check(set(images) == want_names, f'intermediate outputs {sorted(images)}')
    check({f'GS{i}' for i in range(5)} <= set(runs[0]),
          f'run_tiles keys {sorted(runs[0])}')
    check(counts == want, f'intermediates: launches {counts}, want {want}')
    check(gs_equal, 'intermediates: GS differs from the full forward')
    check(same, 'intermediates: two runs differ')
    return dict(trunk=counts['float32'] // n,
                plane_stats=counts['plane_stats'] // n)


@contextlib.contextmanager
def plain_kernels(FR, L):
    """The float32 session's kernels swapped for their plain versions for
    the duration of the block: the trunk conv (cuDNN float32 and the sums)
    and the norm statistics (torch's two-pass mean)."""
    conv, stats = FR.conv3x3_stats, L.plane_mean_var
    FR.conv3x3_stats = FR.conv3x3_stats_reference
    L.plane_mean_var = L.plane_mean_var_reference
    try:
        yield
    finally:
        FR.conv3x3_stats, L.plane_mean_var = conv, stats


def u8_lsb(a, b):
    """(max |a - b|, share of pixels that differ) of two uint8 images."""
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def family_checks(M, K, root, name, model, m, input_no, seg_nets, extra):
    """One model family at its published defaults through the port's entry
    points: a native dir of random weights, the main path
    (``infer_modalities``) with its launches (the float32 trunk kernel, 18
    per translator, and the statistics kernel), run to run and batch
    invariance byte-equal, the session against itself with the plain
    versions of its kernels (uint8 within 1 LSB on < 0.1 % of pixels), the
    per-seg scoring (DeepLIIFExt), tiles/s and peak memory. The sessions
    compute in float32 at any precision (the JAX family definitions)."""
    from PIL import Image
    from deepliif_tpu_torch.models import cyclegan, deepliif_ext, sdg
    FR, L = K[0], K[2]
    md = os.path.join(root, name)
    arch = {k: FLAGSHIP_CFG[k] for k in ('netG', 'ngf')}
    cfg = dict(model=model, modalities_no=m, input_no=input_no, norm='batch',
               padding='zero', upsample='convtranspose', scale_size=TILE,
               modalities_names=[f'mod{i}' for i in range(m + input_no)],
               **arch, **extra)
    nets_kw = dict(modalities_no=m, ngf=arch['ngf'],
                   net_g=(arch['netG'],) * m)
    if model == 'CycleGAN':
        nets_ = cyclegan.make_nets(cyclegan.CycleGANDef(**nets_kw))
    elif model == 'SDG':
        nets_ = sdg.make_nets(sdg.SDGDef(input_no=input_no, **nets_kw))
    else:
        nets_ = deepliif_ext.make_nets(deepliif_ext.DeepLIIFExtDef(
            net_gs=(extra['net_gs'],) * m, **nets_kw))
    write_model_dir(md, nets_, cfg, seed=SEED + len(name))
    del nets_
    images_in = [Image.fromarray(ihc_like_image(2 * TILE, SEED + i))
                 for i in range(input_no)]
    img = images_in[0] if input_no == 1 else Image.fromarray(np.concatenate(
        [np.asarray(im) for im in images_in], axis=1))
    # the precision option does not reach these families: ask for bf16
    kw = dict(device='cuda', max_batch=BATCH, precision='bfloat16')
    t0 = time.perf_counter()
    session = M.init_nets(md, **kw)
    phase('session', path=name, seconds=time.perf_counter() - t0,
          family=session.family, dtype=session.d.dtype,
          groups=list(session.nets.groups))
    check(session.d.dtype == torch.float32, f'{name}: dtype '
                                            f'{session.d.dtype}')
    forwards = count_forwards(session)
    torch.cuda.synchronize()
    reset_counts(K)
    t0 = time.perf_counter()
    images, scoring = M.infer_modalities(img, TILE, md, device_quant=False,
                                         **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, n = launch_counts(K), len(forwards)
    del session.forward
    want = path_counts('float32', TRUNK_PER_NET * m,
                       PLANE_PER_TRANSLATOR * m + PLANE_PER_UNET * seg_nets,
                       n)
    phase('main_path', path=name, seconds=seconds, batch_forwards=n,
          kernel_launches=counts, outputs=sorted(images), scoring=scoring)
    check(n >= 1, f'{name}: no batch forward ran')
    check(counts == want, f'{name}: kernel launches {counts} for {n} '
                          f'forwards, want {want}')
    prefix = 'GB' if extra.get('BtoA') else 'GA'
    want_names = ({f'{prefix}_{i + 1}' for i in range(m)}
                  if model == 'CycleGAN' else
                  {f'mod{i + 1}' for i in range(m)} | {
                      f'Seg{i + 1}{suffix}' for i in range(seg_nets)
                      for suffix in ('', '_Overlaid', '_Refined')})
    check(set(images) == want_names, f'{name}: outputs {sorted(images)}')
    for k, im in images.items():
        a = np.asarray(im)
        check(a.shape == (2 * TILE, 2 * TILE, 3) and a.dtype == np.uint8,
              f'{name} {k}: {a.shape} {a.dtype}')
    if seg_nets:
        check(set(scoring) == {f'Seg{i + 1}' for i in range(seg_nets)}
              and all({'num_total', 'num_pos', 'num_neg', 'percent_pos'}
                      <= set(v) for v in scoring.values()),
              f'{name}: per-seg scoring {scoring}')
    else:
        check(scoring is None, f'{name}: scoring {scoring}')

    images2, scoring2 = M.infer_modalities(img, TILE, md, device_quant=False,
                                           **kw)
    same = all(np.array_equal(np.asarray(images[k]), np.asarray(images2[k]))
               for k in images) and scoring == scoring2
    phase('run_to_run', path=name, byte_equal=same)
    check(same, f'{name}: two runs differ')

    with plain_kernels(FR, L):
        plain, _ = M.infer_modalities(img, TILE, md, device_quant=False, **kw)
    vs_plain = {k: u8_lsb(images[k], plain[k]) for k in images}
    phase('session_vs_plain_kernels', path=name, max_lsb_and_share=vs_plain,
          limit=[1, FAMILY_U8_SHARE])
    check(all(d <= 1 and share < FAMILY_U8_SHARE
              for d, share in vs_plain.values()),
          f'{name}: session vs its plain kernels {vs_plain}')

    batch = crops(img, BATCH, SEED + 1) if input_no == 1 else np.concatenate(
        [crops(im, BATCH, SEED + 1) for im in images_in], axis=-1)
    batch_invariance_checks(session, batch, name)
    tput = throughput(session, batch)
    phase('throughput', path=name, **tput)
    return dict(trunk=counts['float32'] // n,
                plane_stats=counts['plane_stats'] // n, tput=tput,
                vs_plain=vs_plain)


def s8_plain_spy(C):
    """Swaps ``C.conv2d_s8`` / ``C.conv_transpose2d_s8`` for wrappers that
    hold each call's kernel output against its plain version on the same
    inputs; returns (calls, restore): ``calls`` collects (kind, k, equal)."""
    calls, conv, convt = [], C.conv2d_s8, C.conv_transpose2d_s8

    def spy(fn, ref, kind):
        def run(x, qc, bias=None, *args):
            y = fn(x, qc, bias, *args)
            calls.append((kind, qc.w_q.shape[0],
                          bool(torch.equal(y, ref(x, qc, bias, *args)))))
            return y
        return run
    C.conv2d_s8 = spy(conv, C.conv2d_s8_reference, 'conv')
    C.conv_transpose2d_s8 = spy(convt, C.conv_transpose2d_s8_reference,
                                'convT')

    def restore():
        C.conv2d_s8, C.conv_transpose2d_s8 = conv, convt
    return calls, restore


def att_unet_checks(M, K, root, dl, img):
    """A flagship dir with ``unet_512_attention`` seg nets at float32,
    bfloat16 and int8 scope 'all' (static scales calibrated on the crops
    first) through ``infer_modalities``: run to run, batch invariance, the
    trunk launches (72), the statistics calls (4 x 5 translator norms + 5
    x 34 per attention U-Net: 6 encoder, 7 up and 21 gate norms), no norm
    input copied; at int8 the ``conv_s8`` launches (16 translator + 5 x 28
    attention-net convs) and every call of one batch forward bit-equal to
    its plain version, the 1x1 gate convs among them."""
    C = K[4]
    md = os.path.join(root, 'att_unet')
    os.makedirs(md)
    write_flagship_model_dir(md, dl, net_gs='unet_512_attention')
    out = {}
    for precision in ('float32', 'bfloat16', 'int8'):
        kw = dict(device='cuda', max_batch=BATCH, precision=precision)
        session = M.init_nets(md, **kw)
        batch = crops(img, BATCH, SEED + 1)
        if precision == 'int8':
            session.calibrate_int8(batch, save=False)
        forwards = count_forwards(session)
        torch.cuda.synchronize()
        reset_counts(K)
        images, scoring = M.infer_modalities(img, TILE, md,
                                             device_quant=False, **kw)
        torch.cuda.synchronize()
        counts, n = launch_counts(K), len(forwards)
        del session.forward
        want = path_counts(precision, 4 * TRUNK_PER_NET,
                           4 * PLANE_PER_TRANSLATOR + 5 * PLANE_PER_ATT_UNET,
                           n)
        if precision == 'int8':
            want['conv_s8'] = n * (4 * 4 + 5 * S8_PER_ATT_UNET)
        images2, _ = M.infer_modalities(img, TILE, md, device_quant=False,
                                        **kw)
        same = all(np.array_equal(np.asarray(images[k]),
                                  np.asarray(images2[k])) for k in images)
        s8 = None
        if precision == 'int8':
            calls, restore = s8_plain_spy(C)
            try:
                with torch.no_grad():
                    session.forward(torch.from_numpy(batch))
            finally:
                restore()
            s8 = dict(calls=len(calls), bit_equal=sum(c[2] for c in calls),
                      calls_1x1=sum(c[1] == 1 for c in calls),
                      bit_equal_1x1=sum(c[2] for c in calls if c[1] == 1))
        j = min(3, len(batch) - 1)
        full = session.run_tiles(batch)
        alone = session.run_tiles(batch[j:j + 1])
        inv = {k: bool(np.array_equal(full[k][j], alone[k][0]))
               for k in full}
        tput = throughput(session, batch)
        phase('att_unet', precision=precision, batch_forwards=n,
              kernel_launches=counts, outputs=sorted(images),
              run_to_run_byte_equal=same, tile_alone_vs_in_batch=inv,
              conv_s8_vs_plain=s8, scoring=scoring, **tput)
        check(counts == want, f'att_unet {precision}: launches {counts}, '
                              f'want {want}')
        if s8 is not None:
            check(s8['calls'] == want['conv_s8'] // n
                  and s8['bit_equal'] == s8['calls']
                  and s8['calls_1x1'] == 5 * 14,
                  f'att_unet int8: conv_s8 against its plain version {s8}')
        check(set(images) == OUTPUTS, f'att_unet outputs {sorted(images)}')
        check(same, f'att_unet {precision}: two runs differ')
        check(all(inv.values()), f'att_unet {precision}: a tile alone '
                                 f'differs from the same tile in a batch '
                                 f'of {BATCH}: {inv}')
        out[precision] = dict(trunk=counts[precision] // n,
                              plane_stats=counts['plane_stats'] // n,
                              conv_s8=counts['conv_s8'] // n, tput=tput,
                              s8_vs_plain=s8)
        M._init_nets_cached.cache_clear()
        del session
        gc.collect()
        torch.cuda.empty_cache()
    return out


# the serving, serialize and whole-slide phases: 2 concurrent /api/infer
# requests of 1024^2 (9 tiles of 512^2 each); a device call coalesces
# requests only while their tiles fit max_batch, and on CUDA every call
# runs max_batch tiles, so the server runs at 18, the least batch that two
# requests share (the default 16 never coalesces them; at 32 a lone
# request took 3.7 s, median of 8, on one NVIDIA H100 80GB HBM3 at
# 700.00 W)
SERVE_REQUESTS, SERVE_SIZE, SERVE_MAX_BATCH = 2, 2 * TILE, 18
# the aligned rows of phase 'eval'
EVAL_ROWS = 1
# the server's resolution query for a tile size (serve.RESOLUTION_TILE_SIZE)
RESOLUTION = {512: '40x', 256: '20x', 128: '10x'}
# the slide: 1600 x 1200 px at AppMag 40 (tile size 512 from the
# metadata), in regions of 1024 (2 x 2 regions, three of them ragged)
WSI_SIZE, WSI_REGION = (1200, 1600), 1024
WSI_DESC = ('Aperio Image Library v12.0.15\n1600x1200 [0,0 1600x1200] '
            '(256x256) RGB|AppMag = 40|MPP = 0.25')


def _multipart(fields):
    body = b''
    for name, data in fields.items():
        body += (f'--smoke\r\nContent-Disposition: form-data; name="{name}"; '
                 f'filename="{name}.png"\r\n\r\n').encode() + data + b'\r\n'
    return body + b'--smoke--\r\n'


def http_post(url, fields, timeout=600):
    """(status, JSON body) of a multipart POST of ``fields``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=_multipart(fields), method='POST',
                                 headers={'Content-Type': 'multipart/form-'
                                          'data; boundary=smoke'})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def png_bytes(arr):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


def ms_summary(ms):
    return {'median_ms': float(np.median(ms)), 'max_ms': float(np.max(ms)),
            'ms': [float(v) for v in ms]}


def serve_checks(M, K, md, smi):
    """The port's REST server (``serve.make_server``, the session loaded and
    its kernels built before it answers) on the float32 flagship: 8
    concurrent /api/infer requests queued behind the dispatcher's device
    lock (an empty blocker tile holds the dispatcher, so that they queue
    together), each response byte-equal to the same request sent alone and
    to ``inference`` + the host quantifier on the session directly; the
    launches of the concurrent part; the 8 again at once with nothing held
    (byte-equal, and their wall ms); /api/batch/infer submit and poll,
    /api/postprocess on a returned Seg, and a 400."""
    import base64
    import io
    import threading
    from PIL import Image
    from deepliif_tpu_torch import postprocessing as pp
    from deepliif_tpu_torch.serve import _b64_png, make_server
    from deepliif_tpu_torch.utils.tiler import InferenceTiler

    t0 = time.perf_counter()
    srv = make_server(md, '127.0.0.1', 0, max_batch=SERVE_MAX_BATCH,
                      device='cuda')
    startup = time.perf_counter() - t0
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{srv.server_address[1]}'
    ds = srv.RequestHandlerClass.get_session()
    session = ds._session
    try:
        arrays = [ihc_like_image(SERVE_SIZE, SEED + 100 + i)
                  for i in range(SERVE_REQUESTS)]
        pngs = [png_bytes(a) for a in arrays]
        query = f'/api/infer?resolution={RESOLUTION[TILE]}'
        out = [None] * len(pngs)
        wall = [None] * len(pngs)

        def client(i):
            t = time.perf_counter()
            out[i] = http_post(url + query, {'img': pngs[i]})
            wall[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(pngs))]
        blocker = threading.Thread(target=ds.run_tiles, args=(
            np.zeros((1, TILE, TILE, 3), np.uint8),))
        forwards = count_forwards(session)
        before = dict(ds.stats)
        torch.cuda.synchronize()
        reset_counts(K)
        with ds._device_lock:
            blocker.start()
            deadline = time.time() + 60
            while ds._q.qsize() and time.time() < deadline:
                time.sleep(0.005)
            time.sleep(0.05)        # the dispatcher waits on the lock now
            for t in threads:
                t.start()
            while ds._q.qsize() < len(pngs) and time.time() < deadline:
                time.sleep(0.01)
            queued = ds._q.qsize()
        for t in threads + [blocker]:
            t.join(timeout=600)
        torch.cuda.synchronize()
        counts, n = launch_counts(K), len(forwards)
        del session.forward
        stats = {k: ds.stats[k] - before[k] for k in ('device_calls',
                                                      'coalesced_calls')}
        health = http_get(url + '/healthz')
        check(all(s == 200 for s, _ in out),
              f'serve: statuses {[s for s, _ in out]}')
        check(queued == len(pngs), f'serve: {queued} of {len(pngs)} '
                                   'requests queued behind the blocker')
        check(stats['coalesced_calls'] >= 1,
              f'serve: no device call carried tiles of more than one '
              f'request {stats}')
        want = expected_counts('float32', False, n)
        check(n >= 1 and counts == want,
              f'serve: launches {counts} for {n} forwards, want {want}')

        # the same requests at once with nothing held: the dispatcher takes
        # the first alone and coalesces what queued behind it
        natural, natural_wall = [None] * len(pngs), [None] * len(pngs)

        def natural_client(i):
            t = time.perf_counter()
            natural[i] = http_post(url + query, {'img': pngs[i]})
            natural_wall[i] = (time.perf_counter() - t) * 1e3

        before = dict(ds.stats)
        threads = [threading.Thread(target=natural_client, args=(i,))
                   for i in range(len(pngs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        natural_stats = {k: ds.stats[k] - before[k]
                         for k in ('device_calls', 'coalesced_calls')}
        equal_natural = [got == want for got, want in zip(natural, out)]

        # the same requests alone, and inference + the host quantifier on
        # the session directly: as the server runs it (a lone request's 9
        # tiles in the bucket of 16 where it holds against 18), and with
        # each call's tiles padded with other tiles to a batch of 16
        filler = crops(Image.fromarray(arrays[-1]), BATCH, SEED + 3)

        def direct(arr, sess):
            img = Image.fromarray(arr)
            images = M.inference(img, tile_size=TILE, overlap_size=OVERLAP,
                                 model_path=md, opt=session.opt,
                                 session=sess)
            marker = images.get(M.find_marker_key(images))
            overlay, refined, scoring = pp.compute_final_results(
                img, images['Seg'], pp.to_array(marker, True),
                RESOLUTION[TILE], 'default', None, None, 150)
            images['SegOverlaid'] = Image.fromarray(overlay)
            images['SegRefined'] = Image.fromarray(refined)
            return {'images': {k: _b64_png(v) for k, v in images.items()},
                    'scoring': json.loads(json.dumps(scoring))}

        lone_wall, equal_alone, equal_direct, equal_16 = [], [], [], []
        for i, png in enumerate(pngs):
            t = time.perf_counter()
            status, alone = http_post(url + query, {'img': png})
            lone_wall.append((time.perf_counter() - t) * 1e3)
            check(status == 200, f'serve: lone request {i}: {status}')
            equal_alone.append(alone == out[i][1])
            equal_direct.append(direct(arrays[i], session) == out[i][1])
            equal_16.append(direct(arrays[i], PaddedSession(
                session, filler)) == out[i][1])

        # a lone 512^2 request: one tile, in the smallest bucket that holds
        small = ihc_like_image(TILE, SEED + 99)
        small_ms = []
        for _ in range(3):
            with batches_run(session) as small_batches:
                t = time.perf_counter()
                status, small_out = http_post(url + query,
                                              {'img': png_bytes(small)})
                small_ms.append((time.perf_counter() - t) * 1e3)
            check(status == 200, f'serve: 512^2 request: {status}')
        small_16 = direct(small, PaddedSession(session, filler)) == \
            small_out

        # the async contract, the postprocess endpoint, a client error
        status, task = http_post(
            f'{url}/api/batch/infer?resolution={RESOLUTION[TILE]}',
            {'img': pngs[0]})
        check(status == 200 and 'task_id' in task, f'batch submit {task}')
        for _ in range(600):
            polled = http_get(f'{url}/api/batch/infer/{task["task_id"]}')
            if polled['state'] != 'PENDING':
                break
            time.sleep(0.1)
        seg = np.asarray(Image.open(io.BytesIO(base64.b64decode(
            out[0][1]['images']['Seg']))))
        status_pp, post = http_post(
            f'{url}/api/postprocess?resolution={RESOLUTION[TILE]}',
            {'img': pngs[0], 'seg_img': png_bytes(seg)})
        overlay, refined, scoring = pp.compute_final_results(
            Image.fromarray(arrays[0]), Image.fromarray(seg), None,
            RESOLUTION[TILE], 'default', None, None, 150)
        status_400, err = http_post(url + query, {'other': b'x'})
    finally:
        srv.shutdown()
        srv.server_close()
        ds.close()
    phase('serve', nvidia_smi=smi, requests=len(pngs), image=SERVE_SIZE,
          max_batch=SERVE_MAX_BATCH, startup_seconds=startup,
          tiles_per_request=len(InferenceTiler(arrays[0], TILE,
                                               OVERLAP).tiles()),
          concurrent=ms_summary(wall),
          concurrent_note='from each request sent to its response; the '
                          'dispatcher held until all were queued',
          alone=ms_summary(lone_wall), dispatch=stats,
          concurrent_unheld=ms_summary(natural_wall),
          dispatch_unheld=natural_stats,
          unheld_byte_equal_to_held=equal_natural,
          healthz_dispatch=health.get('dispatch'), batch_forwards=n,
          kernel_launches=counts,
          byte_equal_to_alone=equal_alone,
          byte_equal_to_direct=equal_direct,
          byte_equal_to_batch_of_16=equal_16,
          lone_512_ms=ms_summary(small_ms), lone_512_batch=small_batches,
          lone_512_byte_equal_to_batch_of_16=small_16,
          probes=bucket_probes(session),
          batch_poll=polled['state'], postprocess_status=status_pp,
          scoring=out[0][1]['scoring'], missing_img_status=status_400)
    check(all(equal_alone), f'serve: concurrent != alone {equal_alone}')
    check(all(equal_natural), f'serve: unheld concurrent != held '
                              f'{equal_natural}')
    check(all(equal_direct), f'serve: response != inference + host '
                             f'quantifier {equal_direct}')
    check(all(equal_16) and small_16, f'serve: response != the same tiles '
                                      f'in a batch of {BATCH}: {equal_16}, '
                                      f'512^2: {small_16}')
    check(polled['state'] == 'SUCCESS' and polled['result'] == out[0][1],
          f'serve: batch poll {polled["state"]}')
    check(status_pp == 200 and post['scoring'] == json.loads(json.dumps(
        scoring)) and post['images']['SegRefined'] == _b64_png(
            Image.fromarray(refined)), 'serve: /api/postprocess differs from '
                                       'the host quantifier')
    check(status_400 == 400 and 'img' in err['error'],
          f'serve: missing img gave {status_400} {err}')
    return dict(trunk=counts['float32'] // n,
                plane_stats=counts['plane_stats'] // n,
                median_ms_alone=float(np.median(lone_wall)),
                median_ms_concurrent=float(np.median(natural_wall)),
                median_ms_512=float(np.median(small_ms)),
                batch_512=small_batches)


class PaddedSession:
    """A session whose ``run_tiles`` runs the caller's tiles padded with
    ``filler`` tiles to a batch of BATCH (or more, in batches of BATCH),
    and returns the caller's tiles' outputs."""

    def __init__(self, session, filler):
        self._session, self._filler = session, filler

    def __getattr__(self, name):
        return getattr(self._session, name)

    def run_tiles(self, tiles, **kw):
        n = len(tiles)
        pad = -n % BATCH
        out = {}
        for i in range(0, n + pad, BATCH):
            part = np.concatenate([tiles, self._filler[:pad]])[i:i + BATCH]
            for k, v in self._session.run_tiles(part, **kw).items():
                out.setdefault(k, []).append(v)
        return {k: np.concatenate(v)[:n] for k, v in out.items()}


def serve_int8_checks(M, K, md, smi):
    """The flagship through the REST server at ``--precision int8`` (scope
    'all', dynamic with calibration off, then static scales calibrated on
    the first request into act_scales.json, deleted after): one 1024^2
    request after the first, its launches of the int8 trunk kernel (#2)
    and of conv_s8 held to 72 and 96 (92 dynamic, each with its max pass)
    per forward, and no float trunk."""
    from deepliif_tpu_torch.serve import make_server
    import threading
    png = png_bytes(ihc_like_image(SERVE_SIZE, SEED + 100))
    query = f'/api/infer?resolution={RESOLUTION[TILE]}'
    res = {}
    for mode in ('dynamic', 'static'):   # static writes act_scales.json
        srv = make_server(md, '127.0.0.1', 0, max_batch=SERVE_MAX_BATCH,
                          device='cuda', precision='int8',
                          int8_calibrate=mode == 'static')
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f'http://127.0.0.1:{srv.server_address[1]}'
        ds = srv.RequestHandlerClass.get_session()
        session = ds._session
        try:
            first, _ = http_post(url + query, {'img': png})
            forwards = count_forwards(session)
            torch.cuda.synchronize()
            reset_counts(K)
            t = time.perf_counter()
            status, body = http_post(url + query, {'img': png})
            ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            counts, n = launch_counts(K), len(forwards)
            del session.forward
            scope = session.int8_scope
            modes = [g.int8_mode for g in session.nets.G]
        finally:
            srv.shutdown()
            srv.server_close()
            ds.close()
        want = expected_counts('int8', False, n, s8=S8_PER_FORWARD[mode],
                               s8_dynamic=mode == 'dynamic')
        phase('serve_int8', mode=mode, nvidia_smi=smi, status=[first, status],
              request_ms=ms, int8_scope=scope, trunk_modes=modes,
              batch_forwards=n, kernel_launches=counts,
              int8_trunk_per_forward=counts['int8'] / max(n, 1),
              conv_s8_per_forward=counts['conv_s8'] / max(n, 1),
              scoring=body.get('scoring') if isinstance(body, dict) else None)
        check(first == 200 and status == 200, f'serve int8 {mode}: statuses '
                                              f'{first}, {status}')
        check(scope == 'all' and all(m_ == mode for m_ in modes),
              f'serve int8 {mode}: scope {scope}, trunk modes {modes}')
        check(n >= 1 and counts == want, f'serve int8 {mode}: launches '
                                         f'{counts} for {n} forwards, want '
                                         f'{want}')
        res[mode] = {'trunk': counts['int8'] // n,
                     'plane_stats': counts['plane_stats'] // n,
                     'conv_s8': counts['conv_s8'] // n,
                     's8_absmax': counts['s8_absmax'] // n}
        M._init_nets_cached.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()
    act = os.path.join(md, 'act_scales.json')
    check(os.path.exists(act), 'serve int8 static: no act_scales.json')
    os.remove(act)
    return res


def eval_checks(M, K, md, root):
    """The CLI's ``eval`` on the card over EVAL_ROWS aligned rows (A |
    B1..B4 | B_seg, crops of ``ihc_like_image``): its launches per forward;
    each written image byte-equal to ``run_tiles`` of that row's A tile on
    the same session (real_A the tile itself, fake_B_i modality i,
    fake_B_5 the seg); index.html lists every image."""
    from PIL import Image
    from deepliif_tpu_torch import cli
    from deepliif_tpu_torch.config import get_opt
    from deepliif_tpu_torch.data.aligned import AlignedDataset
    rows = os.path.join(root, 'eval_rows', 'test')
    os.makedirs(rows)
    for i in range(EVAL_ROWS):
        tiles = crops(Image.fromarray(ihc_like_image(2 * TILE, SEED + 200 + i)),
                      6, SEED + i)
        Image.fromarray(np.concatenate(list(tiles), axis=1)).save(
            os.path.join(rows, f'row{i}.png'))
    out_dir = os.path.join(root, 'eval_out')
    session = M.init_nets(md, device='cuda')     # the one eval loads
    forwards = count_forwards(session)           # its bucket probes too
    torch.cuda.synchronize()
    reset_counts(K)
    t0 = time.perf_counter()
    with batches_run(session) as batches:
        cli.make_cli().main(['eval', '--dataroot', os.path.dirname(rows),
                             '--model-dir', md, '--output-dir', out_dir,
                             '--device', 'cuda'], standalone_mode=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, n = launch_counts(K), len(forwards)
    del session.forward
    want = expected_counts('float32', False, n)
    opt = copy.copy(get_opt(md, mode='test'))
    opt.dataroot, opt.preprocess, opt.no_flip = os.path.dirname(rows), \
        'none', True
    ds = AlignedDataset(opt, phase='test')
    equal, files = {}, sorted(os.listdir(out_dir))
    for i in range(len(ds)):
        item = ds[i]
        a_u8 = ((item['A'] + 1) * 127.5).astype(np.uint8)[None]
        res = session.run_tiles(a_u8)
        want_images = {'real_A': a_u8[0], **{
            'fake_B_5' if k == 'GS' else f'fake_B_{k[1:]}': v[0]
            for k, v in res.items()}}
        stem = os.path.splitext(os.path.basename(item['A_paths']))[0]
        for label, arr in want_images.items():
            f = f'{stem}_{label}.png'
            equal[f] = f in files and np.array_equal(
                np.asarray(Image.open(os.path.join(out_dir, f))), arr)
    with open(os.path.join(out_dir, 'index.html')) as f:
        html = f.read()
    pngs = [f for f in files if f.endswith('.png')]
    listed = all(f'src="{f}"' in html for f in pngs)
    phase('eval', rows=EVAL_ROWS, seconds=seconds, batches=batches,
          forwards_with_probes=n, kernel_launches=counts, images=len(pngs),
          byte_equal_to_run_tiles=all(equal.values()), gallery_lists_all=listed)
    check(len(batches) == EVAL_ROWS and counts == want,
          f'eval: launches {counts} for {n} forwards ({batches} of the rows), '
          f'want {want}')
    check(len(pngs) == len(equal) == EVAL_ROWS * 6 and all(equal.values()),
          f'eval: images differ from run_tiles of the A tiles: {equal}')
    check(listed, 'eval: index.html does not list every image')
    return {'trunk': counts['float32'] // n,
            'plane_stats': counts['plane_stats'] // n}


def write_reference_dir(session, out):
    """The nets of a flagship session as a reference-layout dir:
    latest_net_G{i}.pth and latest_net_GS{i}.pth state dicts and the
    session's config.json."""
    os.makedirs(out)
    for i, net in enumerate(session.nets.G):
        torch.save(net.state_dict(), os.path.join(out,
                                                  f'latest_net_G{i + 1}.pth'))
    for i, net in enumerate(session.nets.GS):
        torch.save(net.state_dict(), os.path.join(out,
                                                  f'latest_net_GS{i}.pth'))
    with open(os.path.join(session.model_dir, 'config.json')) as f:
        cfg = f.read()
    with open(os.path.join(out, 'config.json'), 'w') as f:
        f.write(cfg)


def serialize_checks(M, K, md, root):
    """The port's ``serialize`` on a reference-layout flagship dir on the
    card: the parity gate (sum |diff| <= 10 on a seeded 512^2 tile, both
    sessions on the card) passes, and the written npz files hold the keys
    and the array bytes of ``params_to_jax`` of the nets loaded from the
    reference dir."""
    from deepliif_tpu_torch import cli
    from deepliif_tpu_torch.utils import checkpoints as ck

    ref, out = os.path.join(root, 'reference'), os.path.join(root, 'native')
    write_reference_dir(M.init_nets(md, device='cuda'), ref)
    M._init_nets_cached.cache_clear()
    torch.cuda.synchronize()
    reset_counts(K)
    t0 = time.perf_counter()
    with session_forwards(M) as calls:
        diff = cli.run_serialize(ref, out, device='cuda',
                                 echo=lambda *_: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, n = launch_counts(K), len(calls)
    loaded = M.InferenceSession(ref, device='cpu')
    same, files = True, sorted(f for f in os.listdir(out)
                               if f.endswith('.npz'))
    for name, group in loaded.nets.named_groups():
        with np.load(os.path.join(out, f'latest_net_{name}.npz')) as data:
            written = {k: data[k] for k in data.files}
        for i, net in enumerate(group):
            want = ck.flatten_tree(ck.params_to_jax(net))
            same = same and sorted(written) == sorted(want) and all(
                written[k][i].dtype == want[k].dtype
                and written[k][i].tobytes() == want[k].tobytes()
                for k in want)
    del loaded
    # the gate's two sessions each run one batch forward of the tile,
    # after their bucket probes
    want_counts = expected_counts('float32', False, n)
    phase('serialize', sum_abs_diff=diff, seconds=seconds, files=files,
          npz_equal_to_loaded_nets=same, forwards=calls,
          kernel_launches=counts)
    check(sum(not raw for _, raw in calls) == 2,
          f'serialize: forwards {calls}, want two of the gate\'s tile')
    check(diff is not None and diff <= 10, f'serialize: parity {diff}')
    check(files == ['latest_net_G.npz', 'latest_net_GS.npz'],
          f'serialize: wrote {files}')
    check(same, 'serialize: the npz differs from params_to_jax of the '
                'loaded nets')
    check(counts == want_counts, f'serialize: launches {counts}, want '
                                 f'{want_counts}')
    return dict(trunk=counts['float32'] // n,
                plane_stats=counts['plane_stats'] // n, sum_abs_diff=diff)


def wsi_slide(path):
    """A pyramidal TIFF of WSI_SIZE from IHC-like content with an Aperio
    description at AppMag 40; returns its pixels."""
    from deepliif_tpu_torch.utils import tiff
    h, w = WSI_SIZE
    pixels = np.ascontiguousarray(ihc_like_image(max(h, w), SEED + 7)[:h, :w])
    tiff.write_pyramid_tiff(path, pixels, description=WSI_DESC)
    return pixels


def wsi_regions():
    h, w = WSI_SIZE
    return [(x, y, min(WSI_REGION, w - x), min(WSI_REGION, h - y))
            for y in range(0, h, WSI_REGION) for x in range(0, w, WSI_REGION)]


def wsi_checks(M, K, md, root, smi):
    """``test-wsi`` (tile size from the slide's AppMag, 2 x 2 regions) and
    ``wsi-cells`` through the port's CLI on the float32 flagship: every
    .ome.tiff written and read back, each level 0 byte-equal to the stitch
    of ``infer_modalities`` on each region alone, the slide JSON the sum of
    the per-region scorings, a second run byte-equal; the cells equal to
    the per-region cell quantifier's, offset to slide coordinates."""
    from click.testing import CliRunner
    from PIL import Image
    from deepliif_tpu_torch import cli, postprocessing as pp
    from deepliif_tpu_torch.utils import tiff

    slides = os.path.join(root, 'slides')
    os.makedirs(slides)
    pixels = wsi_slide(os.path.join(slides, 'slide.svs'))
    session = M.init_nets(md, device='cuda')

    def run(cmd, out):
        forwards = count_forwards(session)
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        res = CliRunner().invoke(cli.make_cli(), [
            cmd, '--input-dir', slides, '--filename', 'slide.svs',
            '--output-dir', out, '--model-dir', md, '--region-size',
            str(WSI_REGION), '--device', 'cuda'])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, n = launch_counts(K), len(forwards)
        del session.forward
        if res.exception is not None:
            import traceback
            traceback.print_exception(res.exception)
        check(res.exit_code == 0, f'{cmd}: {res.output}')
        return res.output, seconds, counts, n

    outs = [os.path.join(root, f'wsi{i}') for i in range(2)]
    output, seconds, counts, n = run('test-wsi', outs[0])
    _, seconds2, _, _ = run('test-wsi', outs[1])
    names = sorted(OUTPUTS)
    files = sorted(os.listdir(outs[0]))
    check(files == sorted([f'slide_{k}.ome.tiff' for k in names]
                          + ['slide.json']), f'test-wsi wrote {files}')
    same_bytes = True
    for fn in files:
        with open(os.path.join(outs[0], fn), 'rb') as a, \
                open(os.path.join(outs[1], fn), 'rb') as b:
            same_bytes = same_bytes and a.read() == b.read()
    levels = {}
    for k in names:
        r = tiff.TiledTiffReader(os.path.join(outs[0], f'slide_{k}.ome.tiff'))
        check(r.size == (WSI_SIZE[1], WSI_SIZE[0]), f'{k}: size {r.size}')
        levels[k] = r.read_region(0, 0, *r.size)
        r.close()
    with open(os.path.join(outs[0], 'slide.json')) as f:
        slide_scoring = json.load(f)

    # the stitch of infer_modalities on each region alone
    stitch = {k: np.zeros_like(v) for k, v in levels.items()}
    total = {'num_total': 0, 'num_pos': 0, 'num_neg': 0}
    cells, size_t, marker_t = [], [], []
    for x, y, w, h in wsi_regions():
        region = Image.fromarray(pixels[y:y + h, x:x + w])
        images, scoring = M.infer_modalities(region, TILE, md, device='cuda')
        for k, im in images.items():
            stitch[k][y:y + h, x:x + w] = np.asarray(im)
        for k in total:
            total[k] += scoring[k]
        seg_only = M.inference(region, tile_size=TILE, overlap_size=OVERLAP,
                               model_path=md, opt=session.opt, seg_only=True,
                               session=session)
        data = pp.compute_cell_results(
            seg_only['Seg'], seg_only.get(M.find_marker_key(seg_only)),
            RESOLUTION[TILE], version=3)
        size_t.append(data['settings']['default_size_thresh'])
        if data['settings'].get('default_marker_thresh') is not None:
            marker_t.append(data['settings']['default_marker_thresh'])
        for c in data['cells']:
            c['bbox'] = [(c['bbox'][0][0] + x, c['bbox'][0][1] + y),
                         (c['bbox'][1][0] + x, c['bbox'][1][1] + y)]
            c['centroid'] = (c['centroid'][0] + x, c['centroid'][1] + y)
            c['boundary'] = [(bx + x, by + y) for bx, by in c['boundary']]
            cells.append(pp.encode_cell_data_v4(c))
    total['percent_pos'] = (round(total['num_pos'] / total['num_total']
                                  * 100, 1) if total['num_total'] else 0)
    stitched = {k: bool(np.array_equal(levels[k], stitch[k])) for k in names}

    cells_out = os.path.join(root, 'cells')
    _, cells_seconds, cell_counts, cell_n = run('wsi-cells', cells_out)
    with open(os.path.join(cells_out, 'slide_cells.json')) as f:
        got_cells = json.load(f)
    cells_equal = got_cells['cells'] == json.loads(json.dumps(cells))
    n_regions = len(wsi_regions())
    phase('wsi', nvidia_smi=smi, slide=list(WSI_SIZE), region=WSI_REGION,
          regions=n_regions, tile_from_metadata=f'tile size {TILE} from '
          'slide magnification metadata' in output,
          seconds=[seconds, seconds2],
          regions_per_s=[n_regions / seconds, n_regions / seconds2],
          batch_forwards=n, kernel_launches=counts, files=files,
          byte_equal_run_to_run=same_bytes, equal_to_region_stitch=stitched,
          scoring=slide_scoring, per_region_sum=total,
          cells=len(got_cells['cells']), per_region_cells=len(cells),
          cells_equal=cells_equal, cells_seconds=cells_seconds,
          cells_batch_forwards=cell_n, cells_kernel_launches=cell_counts)
    check(f'tile size {TILE} from slide magnification metadata' in output,
          f'test-wsi: tile size not from the metadata: {output}')
    want = expected_counts('float32', False, n)
    check(n >= 1 and counts == want, f'test-wsi: launches {counts} for {n} '
                                     f'forwards, want {want}')
    check(same_bytes, 'test-wsi: two runs differ')
    check(all(stitched.values()), f'test-wsi: not the per-region stitch '
                                  f'{stitched}')
    check(slide_scoring == total, f'test-wsi: scoring {slide_scoring} != the '
                                  f'per-region sum {total}')
    check(cells_equal and len(got_cells['cells']) == len(cells),
          f'wsi-cells: {len(got_cells["cells"])} cells, per region '
          f'{len(cells)}')
    # seg-only (seg_only_checks): the translators of the weighted seg
    # branches and the marker's, and the seg nets of weight other than 0
    w = session.d.seg_weights
    needed = [i for i in range(4) if w[i + 1] != 0]
    translators = len(set(needed) | {session._marker_index()})
    seg_nets = len(needed) + (w[0] != 0)
    want = path_counts('float32', TRUNK_PER_NET * translators,
                       PLANE_PER_TRANSLATOR * translators
                       + PLANE_PER_UNET * seg_nets, cell_n)
    check(cell_n >= 1 and cell_counts == want,
          f'wsi-cells: launches {cell_counts} for {cell_n} forwards, want '
          f'{want}')
    return ({'trunk': counts['float32'] // n,
             'plane_stats': counts['plane_stats'] // n,
             'regions_per_s': n_regions / seconds2},
            {'trunk': cell_counts['float32'] // cell_n,
             'plane_stats': cell_counts['plane_stats'] // cell_n})


# training (float32): the statistics Function's shapes (a trunk norm and a
# head norm at batch 2), the step held against the CPU, the CLI's run
TRAIN_STATS_SHAPES = ((2, 256, 128, 128), (2, 64, 512, 512))
TRAIN_STATS_TOL, TRAIN_DX_TOL = 1e-6, 1e-5   # forward rel., dx / max |dx|
TRAIN_STEP_CFG = dict(modalities_no=4, net_g=('resnet_9blocks',) * 4,
                      net_gs=('unet_128',) * 5, n_layers_d=4, ngf=16, ndf=16,
                      use_dropout=False)
TRAIN_STEP_SIZE, TRAIN_BATCH = 128, 2
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3  # loss rel., |Δg| / max |g|
# the card's gradient may also miss the float64 reference by this many
# times the CPU float32 run's own miss (beyond TRAIN_GRAD_TOL max |g|)
TRAIN_GRAD_CPU_FACTOR = 2
# a replayed ReLU branch may differ from the CPU's own only where |x| is
# within this share of that call's max |x| of 0 (rounding, not a fault)
TRAIN_BRANCH_TOL = 1e-4
TRAIN_ROWS, TRAIN_STEPS, TRAIN_REPRO_STEPS = 6, 3, 1
# statistics calls a flagship step: the forward's norms (4 translators of
# 23 with the trunk unfused, 5 unet_512 of 15), 4 in each of the 18
# discriminator calls of the D loss and the 9 of the G loss; the backward
# launches none
PLANE_PER_TRAIN_STEP = 4 * 23 + 5 * 15 + (18 + 9) * 4


def train_stats_checks(L, rnd):
    """``plane_mean_var_train`` (the statistics kernel under autograd) on
    the card, forward and backward, against autograd of
    ``plane_mean_var_reference``, float32, channels_last and NCHW: forward
    within TRAIN_STATS_TOL of max |statistic|, dx within TRAIN_DX_TOL of
    max |dx|; one kernel launch per forward. Both timed (forward +
    backward) in turns."""
    out = []
    for shape in TRAIN_STATS_SHAPES:
        for layout in ('channels_last', 'nchw'):
            x = rnd.big(*shape, dtype=torch.float32) + 0.5
            if layout == 'channels_last':
                x = x.contiguous(memory_format=torch.channels_last)
            g = rnd.big(shape[0], 2, shape[1], dtype=torch.float32)
            xk = x.clone().requires_grad_(True)
            xr = x.clone().requires_grad_(True)
            before = L.plane_mean_var.launches
            st = L.plane_mean_var_train(xk)
            dx, = torch.autograd.grad(st, xk, g)
            launched = L.plane_mean_var.launches - before
            ref = L.plane_mean_var_reference(xr)
            dref, = torch.autograd.grad(ref, xr, g)
            torch.cuda.synchronize()
            fwd = stats_rel(st.detach(), ref.detach())
            dxe = ((dx - dref).abs().max() / dref.abs().max()).item()
            runs, ms = in_turns({
                'plain': lambda: torch.autograd.grad(
                    L.plane_mean_var_reference(xr), xr, g),
                'kernel': lambda: torch.autograd.grad(
                    L.plane_mean_var_train(xk), xk, g)},
                {'plain': 5, 'kernel': 10})
            # x read once forward and once backward, dx written once
            bound_ms = 3 * x.numel() * 4 / PEAK_BYTES * 1e3
            res = dict(shape=list(shape), layout=layout,
                       forward_rel_err=fwd, dx_rel_err=dxe,
                       launches=launched, runs_ms=runs,
                       kernel_ms=ms['kernel'], plain_ms=ms['plain'],
                       bound_ms=bound_ms, bound_by='bytes',
                       bound_share=bound_ms / ms['kernel'])
            phase('train_stats_vs_plain', **res,
                  what='forward (the kernel) + backward (one elementwise '
                       'pass) against autograd of the plain version')
            check(launched == 1, f'train stats: {launched} launches')
            check(fwd <= TRAIN_STATS_TOL, f'train stats {shape} {layout}: '
                                          f'forward {fwd} > {TRAIN_STATS_TOL}')
            check(dxe <= TRAIN_DX_TOL, f'train stats {shape} {layout}: dx '
                                       f'{dxe} > {TRAIN_DX_TOL}')
            out.append(res)
            del x, xk, xr, st, dx, ref, dref
    torch.cuda.empty_cache()
    return out


def train_batch_arrays(size, batch, m, seed):
    """A training batch in [-1, 1] (numpy, NHWC): 'A', 'B_mods', 'B_seg'."""
    rng = np.random.default_rng(seed)
    return {'A': rng.uniform(-1, 1, (batch, size, size, 3)),
            'B_mods': rng.uniform(-1, 1, (m, batch, size, size, 3)),
            'B_seg': rng.uniform(-1, 1, (batch, size, size, 3))}


def named_grads(state):
    return {f'{group}.{i}.{k}': p.grad.detach().cpu()
            for group, nets in state.nets.named_groups()
            for i, net in enumerate(nets)
            for k, p in net.named_parameters() if p.grad is not None}


class SharedBranches:
    """The branch each ReLU and leaky ReLU of the nets takes (its x > 0),
    recorded in call order on the card and replayed on the CPU, so that a
    CPU run differentiates the card's branch of the piecewise-linear
    function. An input within rounding of 0 can take the other branch on
    another device, and a single such position moves the gradient of every
    net upstream of it by a local impulse: percent of the max of a tensor
    whose gradient is a sum with heavy cancellation (a trunk norm's bias,
    the conv weights before it). A replay counts the positions where the
    CPU's own input takes the other branch, and the largest |x| among them
    relative to that call's max |x| (``flips``, ``flip_rel``)."""

    def __init__(self, L):
        self.L = L
        self.masks, self.replay = [], None
        self.flips, self.flip_rel = 0, 0.0

    def _replayed(self, x):
        want = next(self.replay, None)
        check(want is not None and want.shape == x.shape,
              'train_step_vs_cpu: the CPU run calls its ReLUs in another '
              'order than the card')
        want = want.to(x.device)
        off = (x.detach() > 0) != want
        if off.any():
            a = x.detach().abs()
            self.flips += int(off.sum())
            self.flip_rel = max(self.flip_rel,
                                (a[off].max() / a.max()).item())
        return want

    @contextlib.contextmanager
    def on(self, record):
        """Record (the card) or replay (the CPU) inside the block."""
        L = self.L
        relu, leaky = L.relu, L.leaky_relu
        if record:
            self.masks = []

            def b_relu(x):
                self.masks.append((x.detach() > 0).cpu())
                return relu(x)

            def b_leaky(x, slope=0.2):
                self.masks.append((x.detach() > 0).cpu())
                return leaky(x, slope)
        else:
            self.replay = iter(self.masks)

            def b_relu(x):
                return torch.where(self._replayed(x), x, torch.zeros_like(x))

            def b_leaky(x, slope=0.2):
                return torch.where(self._replayed(x), x, slope * x)
        L.relu, L.leaky_relu = b_relu, b_leaky
        try:
            yield self
        finally:
            L.relu, L.leaky_relu = relu, leaky
        if not record:
            check(next(self.replay, None) is None,
                  'train_step_vs_cpu: the CPU run calls fewer ReLUs than '
                  'the card')


def train_step_vs_cpu(dl, vgg):
    """One flagship-layout step (TRAIN_STEP_CFG: 4 resnet_9blocks, 5
    unet_128, n_layers-4 discriminators, ngf = ndf = 16, 128^2, batch 2,
    no dropout) on the card against the same step on the CPU: the same
    weights (drawn on the CPU from one seed), the same batch, TF32 off.
    Every loss term of the step within TRAIN_LOSS_TOL relative. The
    optimizer is held apart: the CPU step's G loss runs against the card's
    updated discriminators (copied in after the CPU's own D update), since
    Adam's first update is lr sign(g) and a D gradient near 0 can take
    either sign on the two devices.

    Gradients: the D gradients of the step and the G gradients, both at the
    initial weights, on the card, the CPU in float32 and a float64
    reference on the CPU. Two step functions are shared, so that each
    difference is rounding: the CPU runs replay the card's ReLU branches
    (``SharedBranches``; every position where a CPU input takes the other
    branch must lie within TRAIN_BRANCH_TOL of 0 relative to that call's
    max |x|), and the perceptual term's gradient w.r.t. the generators'
    outputs is the card's (the loss without the term + <outputs, the
    card's upstream gradient>: the term is an L1 of VGG features, a step
    function of sign(a - b)); that upstream gradient on its own, at the
    card's outputs, within TRAIN_GRAD_TOL of its max plus twice the CPU
    float32 run's distance from float64. Held for each of the 613
    gradient tensors: the card within TRAIN_GRAD_TOL of its max |g| of the
    CPU float32 run, and of the float64 reference plus
    TRAIN_GRAD_CPU_FACTOR times the CPU float32 run's own distance; and
    each net's whole gradient (the 9 generators' and the 9
    discriminators') within TRAIN_GRAD_TOL of float64 in relative L2."""
    import dataclasses
    from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
    from deepliif_tpu_torch.nets import layers as L
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          'train_step_vs_cpu: TF32 is on')
    d = dl.DeepLIIFDef(**TRAIN_STEP_CFG)
    d_rest = dataclasses.replace(d, lambda_feat=0.0)
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    arrays = train_batch_arrays(TRAIN_STEP_SIZE, TRAIN_BATCH,
                                d.modalities_no, SEED)
    w_feat = d.lambda_feat * torch.tensor(
        d.loss_g_weights[:d.modalities_no], dtype=torch.float64)
    branches = SharedBranches(L)
    res, card, flips = {}, {}, {}
    for side, dev, dt in (('card', 'cuda', torch.float32),
                          ('cpu', 'cpu', torch.float32),
                          ('float64', 'cpu', torch.float64)):
        vnet = vgg.VGG19Features().to(dev, dt)
        batch = {k: torch.tensor(v, dtype=dt, device=dev)
                 for k, v in arrays.items()}
        state = dl.create_train_state(d, opt, 1, SEED, dev)
        state.nets.to(dt)
        branches.flips, branches.flip_rel = 0, 0.0
        with branches.on(record=side == 'card'):
            loss, (_, g_out) = dl.g_loss_fn(state.nets, batch, d_rest, vnet)
            # the perceptual term's gradient w.r.t. the outputs: the
            # card's own, and every side's at the card's outputs
            mods = (g_out['mods'] if side == 'card' else card['mods'].to(dt)
                    ).detach().requires_grad_(True)
            up, = torch.autograd.grad((vgg.vgg_loss(
                vnet, mods.movedim(-1, -3), batch['B_mods'].movedim(-1, -3))
                * w_feat.to(dev, dt)).sum(), mods)
            if side == 'card':
                card.update(mods=mods.detach().cpu(), up=up.cpu())
            dl.set_grads(state.g_params, loss + (
                g_out['mods'] * card['up'].to(dev, dt)).sum())
            g_grads = named_grads(state)
            d_loss, _ = dl.d_loss_fn(state.nets, g_out, batch, d)
            dl.set_grads(state.d_params, d_loss)
        if side != 'card':
            flips[side] = dict(positions=branches.flips,
                               max_abs_x_rel=branches.flip_rel)
        d_grads = {k: v for k, v in named_grads(state).items()
                   if k.startswith('D')}
        res[side] = dict(up=up.cpu(), g_grads={
            k: v for k, v in g_grads.items() if k.startswith('G')},
            d_grads=d_grads)
        del state, g_out, loss, d_loss
        if side == 'float64':
            break
        # the step
        state = dl.create_train_state(d, opt, 1, SEED, dev)
        step = dl.make_train_step(d, vnet)
        if side == 'cpu':
            own_update = state.d_opt.step

            def card_update(update=own_update, params=state.d_params):
                update()
                with torch.no_grad():
                    for p, q in zip(params, card['d']):
                        p.copy_(q)
            state.d_opt.step = card_update
        t0 = time.perf_counter()
        _, metrics, _ = step(state, batch)
        torch.cuda.synchronize()
        res[side].update(seconds=time.perf_counter() - t0,
                         metrics={k: v.cpu() for k, v in metrics.items()})
        card['d'] = [p.detach().cpu() for p in state.d_params]
        del state, step, batch, vnet
    relu_calls, branches.masks = len(branches.masks), []
    gc.collect()
    torch.cuda.empty_cache()
    gpu, cpu, ref = res['card'], res['cpu'], res['float64']

    def err(a, b):
        return (a.double() - b.double()).abs().max().item()
    loss_rel = {k: err(gpu['metrics'][k], v) / max(v.abs().max().item(),
                                                   1e-30)
                for k, v in cpu['metrics'].items()}
    tensors = {('up', 'up'): None}
    tensors.update({('d_grads', k): None for k in ref['d_grads']})
    tensors.update({('g_grads', k): None for k in ref['g_grads']})

    def net_l2(side):
        """{net: relative L2 distance of its whole gradient to float64}"""
        acc = {}
        for part in ('d_grads', 'g_grads'):
            for k, want in ref[part].items():
                a = acc.setdefault('.'.join(k.split('.')[:2]), [0.0, 0.0])
                a[0] += (side[part][k].double() - want).pow(2).sum().item()
                a[1] += want.pow(2).sum().item()
        return {k: (a / max(b, 1e-60)) ** 0.5 for k, (a, b) in acc.items()}
    rows, past_cpu, past_f64 = {}, [], []
    nets_l2, cpu_l2 = net_l2(gpu), net_l2(cpu)
    for part, k in tensors:
        want = ref[part] if part == 'up' else ref[part][k]
        got = gpu[part] if part == 'up' else gpu[part][k]
        own = cpu[part] if part == 'up' else cpu[part][k]
        scale = max(want.abs().max().item(), 1e-30)
        e_card, e_cpu = err(got, want), err(own, want)
        rows[k] = dict(card_vs_cpu=err(got, own) / scale,
                       card_vs_float64=e_card / scale,
                       cpu_vs_float64=e_cpu / scale)
        if e_card > TRAIN_GRAD_TOL * scale + TRAIN_GRAD_CPU_FACTOR * e_cpu:
            past_f64.append((k, rows[k]))
        if part != 'up' and rows[k]['card_vs_cpu'] > TRAIN_GRAD_TOL:
            past_cpu.append((k, rows[k]))

    def worst(key, keys=rows):
        k = max(keys, key=lambda n: rows[n][key])
        return k, rows[k][key]
    grad_keys = [k for k in rows if k != 'up']
    phase('train_step_vs_cpu', config={k: str(v) for k, v in
                                       TRAIN_STEP_CFG.items()},
          size=TRAIN_STEP_SIZE, batch=TRAIN_BATCH,
          cuda_seconds=gpu['seconds'], cpu_seconds=cpu['seconds'],
          loss_rel_err=loss_rel, max_loss_rel_err=max(loss_rel.values()),
          d_grad_tensors=len(ref['d_grads']),
          g_grad_tensors=len(ref['g_grads']),
          relu_calls=relu_calls,
          branch_flips_replayed=flips,
          worst_card_vs_cpu=worst('card_vs_cpu', grad_keys),
          worst_card_vs_float64=worst('card_vs_float64', grad_keys),
          worst_cpu_vs_float64=worst('cpu_vs_float64', grad_keys),
          perceptual_upstream=rows['up'],
          nets_relative_l2_vs_float64=nets_l2,
          cpu_nets_relative_l2_vs_float64=cpu_l2,
          max_net_relative_l2=max(nets_l2.values()),
          max_cpu_net_relative_l2=max(cpu_l2.values()),
          tensors_past_cpu_limit=past_cpu,
          tensors_past_float64_limit=past_f64,
          losses={k: v.tolist() for k, v in gpu['metrics'].items()})
    check(max(loss_rel.values()) <= TRAIN_LOSS_TOL,
          f'train_step_vs_cpu: loss terms {loss_rel}')
    for side, f in flips.items():
        check(f['max_abs_x_rel'] <= TRAIN_BRANCH_TOL,
              f'train_step_vs_cpu: a ReLU input of the {side} run takes '
              f'the other branch than the card at {f}')
    check(not past_cpu, f'train_step_vs_cpu: gradient tensors past '
                        f'{TRAIN_GRAD_TOL} max|g| from the CPU: {past_cpu}')
    check(not past_f64, f'train_step_vs_cpu: past {TRAIN_GRAD_TOL} max|g| '
                        f'+ {TRAIN_GRAD_CPU_FACTOR} x the CPU float32 run\'s '
                        f'own error from float64: {past_f64}')
    worst_net = max(nets_l2, key=nets_l2.get)
    check(nets_l2[worst_net] <= TRAIN_GRAD_TOL,
          f'train_step_vs_cpu: net {worst_net} gradient {nets_l2[worst_net]}'
          f' from float64 in relative L2, over {TRAIN_GRAD_TOL}')
    return dict(max_loss_rel_err=max(loss_rel.values()),
                max_net_relative_l2=nets_l2[worst_net],
                max_cpu_net_relative_l2=max(cpu_l2.values()),
                branch_flips_replayed=flips,
                worst_card_vs_cpu=worst('card_vs_cpu', grad_keys),
                worst_card_vs_float64=worst('card_vs_float64', grad_keys),
                worst_cpu_vs_float64=worst('cpu_vs_float64', grad_keys))


def train_rows(dataroot, n, seed):
    """``n`` aligned training rows of 3072 x 512 (A | B1..B4 | B_seg, PNG)
    from IHC-like content: each modality a channel mix of the input, the
    seg black with the nuclei drawn red or blue."""
    from PIL import Image
    os.makedirs(os.path.join(dataroot, 'train'), exist_ok=True)
    for i in range(n):
        a = ihc_like_image(TILE, seed + i)
        f = a.astype(np.float32)
        mods = [np.clip(f[..., perm] * gain, 0, 255).astype(np.uint8)
                for perm, gain in (((2, 1, 0), 1.0), ((1, 1, 1), 0.9),
                                   ((0, 2, 1), 1.1), ((1, 0, 2), 1.0))]
        dark = f.mean(-1) < 160
        seg = np.zeros_like(a)
        seg[dark & (f[..., 2] > f[..., 0])] = (0, 0, 255)
        seg[dark & (f[..., 2] <= f[..., 0])] = (255, 0, 0)
        Image.fromarray(np.concatenate([a] + mods + [seg], axis=1)).save(
            os.path.join(dataroot, 'train', f'row{i}.png'))


def train_checks(M, K, dl, root):
    """The full-width flagship (ngf = ndf = 64, 512^2, batch 2) through the
    CLI's ``train`` on TRAIN_ROWS synthetic rows: TRAIN_STEPS steps, one
    ``latest`` save; every step's loss terms finite, PLANE_PER_TRAIN_STEP
    statistics launches a step and no trunk kernel; s/step (median of
    steps 2..), peak memory, the save's seconds. Then two identical
    TRAIN_REPRO_STEPS-step runs from one seed (saves skipped): their max
    |Δparam| is printed, not held (cuDNN's weight gradients need not be
    bitwise reproducible). Then the checkpoint served back through ``test``
    at float32 on one 512^2 tile: 72 trunk and 95 statistics launches, the
    outputs finite."""
    from PIL import Image as PILImage
    from deepliif_tpu_torch import cli, train_loop

    dataroot, ckpt = os.path.join(root, 'data'), os.path.join(root, 'ckpt')
    train_rows(dataroot, TRAIN_ROWS, SEED + 50)
    steps, saves = [], []
    make_step, save_state = dl.make_train_step, train_loop._save_state

    def timed_make_step(d, vgg_net):
        step = make_step(d, vgg_net)

        def run(state, batch, rng=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch, rng)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0,
                          {k: v.cpu().tolist() for k, v in out[1].items()}))
            return out
        return run

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        save_state(*a, **kw)
        saves.append(time.perf_counter() - t0)

    args = ['train', '--dataroot', dataroot, '--checkpoints-dir', ckpt,
            '--name', 'flagship', '--batch-size', str(TRAIN_BATCH),
            '--n-epochs', '1', '--n-epochs-decay', '0', '--seed', str(SEED),
            '--print-freq', str(TRAIN_BATCH), '--device', 'cuda']
    dl.make_train_step, train_loop._save_state = timed_make_step, timed_save
    try:
        reset_counts(K)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.make_cli().main(args, standalone_mode=False)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = launch_counts(K)
    finally:
        dl.make_train_step, train_loop._save_state = make_step, save_state
    gc.collect()
    torch.cuda.empty_cache()
    md = os.path.join(ckpt, 'flagship')
    per_step = [t for t, _ in steps]
    finite = all(np.isfinite(np.asarray(v, np.float64)).all()
                 for _, m in steps for v in m.values())
    res = dict(steps=len(steps), seconds_per_step=per_step,
               median_s_per_step=float(np.median(per_step[1:])),
               peak_mem_gib=peak / 2 ** 30, save_seconds=saves,
               seconds_total=seconds, kernel_launches=counts,
               plane_stats_per_step=counts['plane_stats'] / max(len(steps), 1),
               files=sorted(os.listdir(md)),
               losses=[m for _, m in steps])
    phase('train', **res)
    check(len(steps) == TRAIN_STEPS, f'train: {len(steps)} steps')
    check(finite, 'train: a loss is not finite')
    check(len(saves) == 1 and os.path.exists(
        os.path.join(md, 'latest_optim.npz')), f'train: saves {saves}')
    check(counts['plane_stats'] == TRAIN_STEPS * PLANE_PER_TRAIN_STEP
          and counts['float32'] == 0,
          f'train: launches {counts}, want {PLANE_PER_TRAIN_STEP} '
          f'statistics a step and no trunk kernel')

    # two identical runs from one seed, through the train command's own
    # argument parsing; without flips, which the loader draws from Python's
    # global random state (unseeded, as in the JAX package)
    repro = [a for a in args if a not in ('train',)] + [
        '--no-flip', '--debug', '--debug-data-size', str(TRAIN_REPRO_STEPS * TRAIN_BATCH),
        '--print-freq', str(10 ** 6), '--checkpoints-dir',
        os.path.join(root, 'repro')]
    train_loop._save_state = lambda *a, **kw: None
    try:
        params = []
        for _ in range(2):
            kwargs = cli.make_cli().commands['train'].make_context(
                'train', list(repro)).params
            state, _ = cli.run_train(kwargs, echo=lambda *_: None)
            params.append([p.detach().cpu() for _, g in
                           state.nets.named_groups() for p in g.parameters()])
            del state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        train_loop._save_state = save_state
    delta = max((a - b).abs().max().item() for a, b in zip(*params))
    phase('train_reproducibility', steps=TRAIN_REPRO_STEPS,
          max_abs_param_delta=delta, bitwise_equal=delta == 0.0)
    del params

    # the checkpoint served through `test`
    imgs, out = os.path.join(root, 'imgs'), os.path.join(root, 'out')
    os.makedirs(imgs)
    PILImage.fromarray(ihc_like_image(TILE, SEED + 90)).save(
        os.path.join(imgs, 'tile.png'))
    reset_counts(K)
    t0 = time.perf_counter()
    with session_forwards(M) as calls:
        cli.run_test(imgs, out, TILE, md, device='cuda', echo=lambda *_: None)
    torch.cuda.synchronize()
    served = time.perf_counter() - t0
    counts, n = launch_counts(K), len(calls)
    pngs = sorted(f for f in os.listdir(out) if f.endswith('.png'))
    means = {f: float(np.asarray(PILImage.open(os.path.join(out, f)),
                                 np.float64).mean()) for f in pngs}
    phase('train_checkpoint_served', seconds=served, outputs=means,
          forwards=calls, kernel_launches=counts)
    check(sum(not raw for _, raw in calls) == 1
          and counts['float32'] == n * LAUNCHES_PER_FORWARD
          and counts['plane_stats'] == n * PLANE_PER_FORWARD[False],
          f'train: served checkpoint launches {counts} for {calls}')
    check(len(pngs) >= 5 and all(np.isfinite(v) for v in means.values()),
          f'train: served outputs {pngs}')
    M._init_nets_cached.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    res.update(repro_delta=delta, served_seconds=served)
    return res


# training of the other families (float32): one step of each at reduced
# width on the card against the CPU, then each through the CLI's train at
# full width. Reduced: ngf = ndf = 16, 128^2, batch 2, no dropout, two
# modalities (one for CycleGAN); the DeepLIIFKD teacher at ngf 32, so
# that its trunk (4 x 32 = 128 channels) runs the float32 trunk kernel
FAMILY_STEP_CASES = {
    'ext': ('DeepLIIFExt', dict(
        modalities_no=2, net_g=('resnet_9blocks',) * 2,
        net_gs=('unet_128',) * 2, loss_g_weights=(0.5, 0.5),
        loss_d_weights=(0.5, 0.5))),
    'sdg': ('SDG', dict(modalities_no=2, input_no=2,
                        net_g=('resnet_9blocks',) * 2,
                        loss_g_weights=(0.5, 0.5),
                        loss_d_weights=(0.5, 0.5))),
    'cyclegan': ('CycleGAN', dict(modalities_no=1,
                                  net_g=('resnet_9blocks',))),
    'kd': ('DeepLIIFKD', dict(
        modalities_no=2, net_g=('resnet_9blocks',) * 2,
        net_gs=('unet_128',) * 3, seg_weights=(0.4, 0.3, 0.3),
        loss_g_weights=(1 / 3,) * 3, loss_d_weights=(1 / 3,) * 3))}
FAMILY_STEP_WIDTH, KD_TEACHER_NGF = 16, 32
# full width through the CLI: (model, modalities, extra options)
FAMILY_TRAIN_CASES = (
    ('ext', 'DeepLIIFExt', 4, ['--net-gs', FLAGSHIP_CFG['net_gs']]),
    ('sdg', 'SDG', 4, ['--input-no', '2']),
    ('cyclegan', 'CycleGAN', 1, []),
    ('kd', 'DeepLIIFKD', 4, ['--net-gs', FLAGSHIP_CFG['net_gs']]))
FAMILY_TRAIN_STEPS = 3
# statistics calls a training step, from the nets: a translator's forward
# in train mode 23 norms (head, 2 down, the trunk's 18, 2 up), a unet_512's
# 15, a discriminator call (n_layers 4) 4; the backward launches none. Ext:
# 4 translators, 4 seg nets, D and DS 4 x 2 calls in the D loss and 4 in
# the G loss each; SDG: 4 translators, D 4 x 2 + 4; CycleGAN: 4 passes of
# a translator, DA and DB 2 calls each in the D step and 1 in the G step;
# DeepLIIFKD: the flagship step plus the teacher's inference forward
# (PLANE_PER_FORWARD[False]: its trunk on the kernel)
TRANSLATOR_TRAIN_NORMS, D_NORMS = 5 + 18, 4
FAMILY_PLANE_PER_STEP = {
    'ext': 4 * TRANSLATOR_TRAIN_NORMS + 4 * PLANE_PER_UNET
    + 2 * (4 * 2 + 4) * D_NORMS,
    'sdg': 4 * TRANSLATOR_TRAIN_NORMS + (4 * 2 + 4) * D_NORMS,
    'cyclegan': 4 * TRANSLATOR_TRAIN_NORMS + 2 * (2 + 1) * D_NORMS,
    'kd': PLANE_PER_TRAIN_STEP + PLANE_PER_FORWARD[False]}
# trunk kernel launches a step: the KD teacher's 4 translators
FAMILY_TRUNK_PER_STEP = {'ext': 0, 'sdg': 0, 'cyclegan': 0,
                         'kd': LAUNCHES_PER_FORWARD}
# the Ext checkpoint served: 4 translators' trunks, 4 x 5 + 4 x 15 norms
EXT_PLANE_PER_FORWARD = 4 * PLANE_PER_TRANSLATOR + 4 * PLANE_PER_UNET


def family_step_batch(name, d, size, batch, seed):
    """A family's training batch in [-1, 1] (numpy NHWC)."""
    rng = np.random.default_rng(seed)
    m = d.modalities_no
    shape = (batch, size, size)
    out = {'A': rng.uniform(-1, 1, shape + (
        3 * getattr(d, 'input_no', 1) if name == 'sdg' else 3,)),
        'B_mods': rng.uniform(-1, 1, (m + (name == 'sdg'),) + shape + (3,))}
    if name == 'ext':
        out['B_segs'] = rng.uniform(-1, 1, (m,) + shape + (3,))
    if name == 'kd':
        out['B_seg'] = rng.uniform(-1, 1, shape + (3,))
    return out


def family_step_parts(name, fam, dl, d, zvgg, teacher):
    """(forward(nets, batch), vgg_pairs(g_out, batch) -> [(output, real,
    weights)], g_loss(nets, batch, g_out) with the zero VGG ``zvgg``,
    d_loss(nets, g_out, batch)) of family ``name``."""
    m = d.modalities_no

    def w(v):
        return torch.tensor(v, dtype=torch.float32)
    if name == 'cyclegan':
        return (lambda nets, b: fam.train_forward(nets, *fam.real_pair(b, d),
                                                  d),
                lambda o, b: [(o['fake_bs'], fam.real_pair(b, d)[1],
                               w(d.loss_g_weights)),
                              (o['fake_as'], fam.real_pair(b, d)[0],
                               w(d.loss_g_weights))],
                lambda nets, b, o: fam.g_loss_fn(nets, *fam.real_pair(b, d),
                                                 d, zvgg, outs=o)[0],
                lambda nets, o, b: fam.d_loss_fn(
                    nets, o['fake_bs'], o['fake_as'], *fam.real_pair(b, d),
                    d)[0])
    if name == 'kd':
        return (lambda nets, b: fam.student_forward_with_branches(
                    nets, b['A'], d),
                lambda o, b: [(o['mods'], b['B_mods'], d.lambda_feat
                               * w(d.loss_g_weights[:m]))],
                lambda nets, b, o: fam.g_loss_fn(nets, b, d, zvgg, teacher,
                                                 g_out=o)[0],
                lambda nets, o, b: dl.d_loss_fn(nets, o, b, d)[0])
    pairs = (lambda o, b: []) if name == 'ext' else (
        lambda o, b: [(o['mods'], b['B_mods'][:m],
                       d.lambda_feat * w(d.loss_g_weights))])
    g_loss = (lambda nets, b, o: fam.g_loss_fn(nets, b, d, g_out=o)[0]) \
        if name == 'ext' else \
        (lambda nets, b, o: fam.g_loss_fn(nets, b, d, zvgg, g_out=o)[0])
    return (lambda nets, b: fam.train_forward(nets, b['A'], d), pairs,
            g_loss, lambda nets, o, b: fam.d_loss_fn(nets, o, b, d)[0])


def zero_vgg(vgg, dev):
    """A VGG19Features of zero weights: its perceptual term is 0 with a
    zero gradient (|0 - 0|)."""
    net = vgg.VGG19Features().to(dev)
    with torch.no_grad():
        for p in net.parameters():
            p.zero_()
    return net


def train_families_vs_cpu(K, dl, vgg):
    """Phase 'train_families_vs_cpu': one step of each family
    (FAMILY_STEP_CASES, ngf = ndf = FAMILY_STEP_WIDTH, TRAIN_STEP_SIZE^2,
    TRAIN_BATCH, no dropout) on the card against the same step on the CPU
    in float32, the same weights (drawn on the CPU from one seed) and
    batch. Gradients at the initial weights, the CPU replaying the card's
    ReLU branches (``SharedBranches``) and the perceptual term's gradient
    w.r.t. the generators' outputs the card's (the G loss with a zero VGG
    plus <outputs, the card's upstream gradient>): every G and D gradient
    tensor within TRAIN_GRAD_TOL of its max |g|. The step: every loss term
    within TRAIN_LOSS_TOL relative, the CPU's G loss against the card's
    updated discriminators (copied in after the CPU's D update; CycleGAN's
    G step runs first, against the initial ones); CycleGAN both steps with
    the host pools between them. The DeepLIIFKD teacher (ngf
    KD_TEACHER_NGF) runs the float32 trunk kernel on the card: its
    launches are counted, none in the other families."""
    import dataclasses
    from deepliif_tpu_torch import models, train_loop
    from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
    from deepliif_tpu_torch.nets import layers as L
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    branches = SharedBranches(L)
    results = {}
    for name, (model, kw) in FAMILY_STEP_CASES.items():
        t_case = time.perf_counter()
        fam = models.family_module(model)
        d = dataclasses.replace(
            fam.def_from_opt(Options(d_params=dict(
                TRAIN_DEFAULTS, modalities_no=kw['modalities_no']))),
            ngf=FAMILY_STEP_WIDTH, ndf=FAMILY_STEP_WIDTH, use_dropout=False,
            **kw)
        arrays = family_step_batch(name, d, TRAIN_STEP_SIZE, TRAIN_BATCH,
                                   SEED + 60)
        teacher_cpu = None
        if name == 'kd':
            td = dataclasses.replace(d, ngf=KD_TEACHER_NGF)
            teacher_cpu = (dl.init_nets(td, torch.Generator().manual_seed(
                SEED + 7), with_discriminators=False).eval()
                .requires_grad_(False), td)
        card, side_res, flips = {}, {}, {}
        for side, dev in (('card', 'cuda'), ('cpu', 'cpu')):
            vnet, zvgg = vgg.VGG19Features().to(dev), zero_vgg(vgg, dev)
            teacher = None if teacher_cpu is None else (
                copy.deepcopy(teacher_cpu[0]).to(dev), teacher_cpu[1])
            fwd, pairs, g_loss, d_loss = family_step_parts(
                name, fam, dl, d, zvgg, teacher)
            batch = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                     for k, v in arrays.items()}
            state = fam.create_train_state(d, opt, 1, SEED, dev)
            branches.flips, branches.flip_rel = 0, 0.0
            with branches.on(record=side == 'card'):
                g_out = fwd(state.nets, batch)
                pr = pairs(g_out, batch)
                src = [(o if side == 'card' else c.to(dev)).detach()
                       .requires_grad_(True) for (o, _, _), c in zip(
                           pr, card.get('outs', [None] * len(pr)))]
                if pr:
                    ups = torch.autograd.grad(sum(
                        (vgg.vgg_loss(vnet, s.movedim(-1, -3),
                                      r.movedim(-1, -3)) * wt.to(dev)).sum()
                        for s, (_, r, wt) in zip(src, pr)), src)
                    if side == 'card':
                        card['outs'] = [s.detach().cpu() for s in src]
                        card['ups'] = [u.cpu() for u in ups]
                loss = g_loss(state.nets, batch, g_out) + sum(
                    (o * u.to(dev)).sum() for (o, _, _), u in zip(
                        pr, card.get('ups', [])))
                dl.set_grads(state.g_params, loss)
                dl.set_grads(state.d_params, d_loss(state.nets, g_out,
                                                    batch))
            if side == 'cpu':
                flips = dict(positions=branches.flips,
                             max_abs_x_rel=branches.flip_rel)
            grads = named_grads(state)
            del state, g_out, loss
            # the step, from fresh weights
            state = fam.create_train_state(d, opt, 1, SEED, dev)
            if model == 'CycleGAN':
                step = train_loop.cyclegan_step(fam, d, vnet, opt, SEED)
            elif model == 'DeepLIIFKD':
                step = fam.make_train_step(d, vnet, teacher)
            else:
                step = fam.make_train_step(d, vnet)
            if side == 'cpu' and model != 'CycleGAN':
                own_update = state.d_opt.step

                def card_update(update=own_update, params=state.d_params):
                    update()
                    with torch.no_grad():
                        for p, q in zip(params, card['d']):
                            p.copy_(q)
                state.d_opt.step = card_update
            if side == 'card':
                torch.cuda.synchronize()
                reset_counts(K)
            t0 = time.perf_counter()
            _, metrics, _ = step(state, batch)
            if side == 'card':
                torch.cuda.synchronize()
                counts = launch_counts(K)
            card['d'] = [p.detach().cpu() for p in state.d_params]
            side_res[side] = dict(
                seconds=time.perf_counter() - t0, grads=grads,
                metrics={k: v.detach().cpu() for k, v in metrics.items()})
            del state, step, batch, vnet, zvgg, teacher
        gc.collect()
        torch.cuda.empty_cache()
        gpu, cpu = side_res['card'], side_res['cpu']
        loss_rel = {k: ((gpu['metrics'][k].double() - v.double()).abs()
                        .max() / max(v.abs().max().item(), 1e-30)).item()
                    for k, v in cpu['metrics'].items()}
        grad_rel = {k: ((gpu['grads'][k].double() - v.double()).abs().max()
                        / max(v.abs().max().item(), 1e-30)).item()
                    for k, v in cpu['grads'].items()}
        worst = max(grad_rel, key=grad_rel.get)
        past = {k: v for k, v in grad_rel.items() if v > TRAIN_GRAD_TOL}
        res = dict(family=name, model=model, config={
            k: str(v) for k, v in kw.items()}, ngf=FAMILY_STEP_WIDTH,
            size=TRAIN_STEP_SIZE, batch=TRAIN_BATCH,
            teacher_ngf=KD_TEACHER_NGF if name == 'kd' else None,
            cuda_step_seconds=gpu['seconds'], cpu_step_seconds=cpu['seconds'],
            loss_rel_err=loss_rel, max_loss_rel_err=max(loss_rel.values()),
            grad_tensors=len(grad_rel), worst_grad=(worst, grad_rel[worst]),
            tensors_past_limit=past, branch_flips_replayed=flips,
            trunk_launches=counts['float32'],
            plane_stats_launches=counts['plane_stats'],
            seconds=time.perf_counter() - t_case)
        phase('train_families_vs_cpu', **res)
        check(sorted(gpu['grads']) == sorted(cpu['grads']),
              f'train_families_vs_cpu {name}: gradient sets differ')
        check(max(loss_rel.values()) <= TRAIN_LOSS_TOL,
              f'train_families_vs_cpu {name}: loss terms {loss_rel}')
        check(not past, f'train_families_vs_cpu {name}: gradient tensors '
                        f'past {TRAIN_GRAD_TOL} max|g|: {past}')
        check(flips['max_abs_x_rel'] <= TRAIN_BRANCH_TOL,
              f'train_families_vs_cpu {name}: a ReLU input takes the other '
              f'branch than the card at {flips}')
        # the teacher's translators, 18 trunk convs each
        want = kw['modalities_no'] * TRUNK_PER_NET if name == 'kd' else 0
        check(counts['float32'] == want,
              f'train_families_vs_cpu {name}: {counts["float32"]} trunk '
              f'launches in the step, want {want}')
        results[name] = {k: res[k] for k in (
            'max_loss_rel_err', 'worst_grad', 'trunk_launches',
            'cuda_step_seconds')}
    return results


def family_train_rows(dataroot, name, n, seed):
    """``n`` training rows (or, for CycleGAN, trainA / trainB1 images) of
    TILE^2 tiles from IHC-like content: modalities as channel mixes of the
    input, segs black with the dark nuclei red or blue."""
    from PIL import Image
    train = os.path.join(dataroot, 'train')
    for i in range(n):
        a = ihc_like_image(TILE, seed + i)
        f = a.astype(np.float32)
        mods = [np.clip(f[..., perm] * gain, 0, 255).astype(np.uint8)
                for perm, gain in (((2, 1, 0), 1.0), ((1, 1, 1), 0.9),
                                   ((0, 2, 1), 1.1), ((1, 0, 2), 1.0),
                                   ((2, 0, 1), 0.8))]
        dark = f.mean(-1) < 160
        seg = np.zeros_like(a)
        seg[dark & (f[..., 2] > f[..., 0])] = (0, 0, 255)
        seg[dark & (f[..., 2] <= f[..., 0])] = (255, 0, 0)
        if name == 'cyclegan':
            for sub, img in (('trainA', a), ('trainB1', mods[0])):
                os.makedirs(os.path.join(dataroot, sub), exist_ok=True)
                Image.fromarray(img).save(os.path.join(dataroot, sub,
                                                       f'{i}.png'))
            continue
        if name == 'ext':           # A | B1..B4 | BS1..BS4
            tiles = [a] + mods[:4] + [np.roll(seg, k * 7, 1)
                                      for k in range(4)]
        elif name == 'sdg':         # A1 A2 | B1..B5
            tiles = [a, mods[4]] + mods[:4] + [seg]
        else:                       # A | B1..B4 | B_seg
            tiles = [a] + mods[:4] + [seg]
        os.makedirs(train, exist_ok=True)
        Image.fromarray(np.concatenate(tiles, axis=1)).save(
            os.path.join(train, f'row{i}.png'))


def family_train_checks(M, K, dl, root, teacher):
    """Phases 'train_ext', 'train_sdg', 'train_cyclegan', 'train_kd': each
    family at full width (ngf = ndf = 64, resnet_9blocks; Ext 4 modalities
    with unet_512 seg nets, SDG 4 modalities on 2 inputs, CycleGAN 1,
    DeepLIIFKD the flagship student distilled from ``teacher``, the
    random-weight flagship dir of the inference phases) through the CLI's
    ``train`` on synthetic rows at
    TILE^2, batch TRAIN_BATCH, FAMILY_TRAIN_STEPS steps and one ``latest``
    save: every loss finite, the statistics launches a step
    FAMILY_PLANE_PER_STEP, the trunk kernel's FAMILY_TRUNK_PER_STEP (the
    KD teacher's 72, none elsewhere); s/step (median of steps 2..), peak
    memory, the save's seconds. Then phase 'train_ext_checkpoint_served':
    the Ext checkpoint through ``test`` at float32 on one TILE^2 tile, 72
    trunk and EXT_PLANE_PER_FORWARD statistics launches a forward, the
    outputs finite."""
    from PIL import Image as PILImage
    from deepliif_tpu_torch import cli, train_loop
    out = {}
    make_step, save_state = train_loop.make_step, train_loop._save_state
    for name, model, m, extra in FAMILY_TRAIN_CASES:
        dataroot = os.path.join(root, f'data_{name}')
        family_train_rows(dataroot, name, FAMILY_TRAIN_STEPS * TRAIN_BATCH,
                          SEED + 70)
        steps, saves = [], []

        def timed_make_step(*a, **kw):
            step = make_step(*a, **kw)

            def run(state, batch, rng=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = step(state, batch, rng)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0,
                              {k: v.cpu().tolist()
                               for k, v in res[1].items()}))
                return res
            return run

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            save_state(*a, **kw)
            saves.append(time.perf_counter() - t0)

        args = ['train', '--dataroot', dataroot, '--checkpoints-dir',
                os.path.join(root, 'ckpt'), '--name', name, '--model', model,
                '--modalities-no', str(m), '--batch-size', str(TRAIN_BATCH),
                '--n-epochs', '1', '--n-epochs-decay', '0', '--seed',
                str(SEED), '--print-freq', str(TRAIN_BATCH), '--load-size',
                str(TILE), '--crop-size', str(TILE), '--ngf',
                str(FLAGSHIP_CFG['ngf']), '--ndf', str(FLAGSHIP_CFG['ngf']),
                '--net-g', FLAGSHIP_CFG['netG'], '--device', 'cuda'] + extra
        if model == 'DeepLIIFKD':
            args += ['--model-dir-teacher', teacher]
        train_loop.make_step, train_loop._save_state = (timed_make_step,
                                                        timed_save)
        try:
            reset_counts(K)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cli.make_cli().main(args, standalone_mode=False)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counts = launch_counts(K)
        finally:
            train_loop.make_step, train_loop._save_state = (make_step,
                                                            save_state)
        M._init_nets_cached.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()
        md = os.path.join(root, 'ckpt', name)
        per_step = [t for t, _ in steps]
        n = max(len(steps), 1)
        finite = all(np.isfinite(np.asarray(v, np.float64)).all()
                     for _, mt in steps for v in mt.values())
        res = dict(model=model, modalities=m, steps=len(steps),
                   seconds_per_step=per_step,
                   median_s_per_step=float(np.median(per_step[1:])),
                   peak_mem_gib=peak / 2 ** 30, save_seconds=saves,
                   seconds_total=seconds, kernel_launches=counts,
                   plane_stats_per_step=counts['plane_stats'] / n,
                   trunk_per_step=counts['float32'] / n,
                   files=sorted(os.listdir(md)),
                   losses=[mt for _, mt in steps])
        phase(f'train_{name}', **res)
        check(len(steps) == FAMILY_TRAIN_STEPS,
              f'train_{name}: {len(steps)} steps')
        check(finite, f'train_{name}: a loss is not finite')
        check(len(saves) == 1 and os.path.exists(
            os.path.join(md, 'latest_optim.npz')), f'train_{name}: saves '
                                                   f'{saves}')
        check(counts['plane_stats'] == FAMILY_PLANE_PER_STEP[name] * n
              and counts['float32'] == FAMILY_TRUNK_PER_STEP[name] * n,
              f'train_{name}: launches {counts}, want '
              f'{FAMILY_PLANE_PER_STEP[name]} statistics and '
              f'{FAMILY_TRUNK_PER_STEP[name]} trunk launches a step')
        out[name] = {k: res[k] for k in (
            'median_s_per_step', 'peak_mem_gib', 'save_seconds',
            'plane_stats_per_step', 'trunk_per_step')}

    # the Ext checkpoint served through `test`
    imgs, outd = os.path.join(root, 'imgs'), os.path.join(root, 'out')
    os.makedirs(imgs)
    PILImage.fromarray(ihc_like_image(TILE, SEED + 91)).save(
        os.path.join(imgs, 'tile.png'))
    reset_counts(K)
    t0 = time.perf_counter()
    with session_forwards(M) as calls:
        cli.run_test(imgs, outd, TILE, os.path.join(root, 'ckpt', 'ext'),
                     device='cuda', echo=lambda *_: None)
    torch.cuda.synchronize()
    served = time.perf_counter() - t0
    counts, n = launch_counts(K), len(calls)
    pngs = sorted(f for f in os.listdir(outd) if f.endswith('.png'))
    means = {f: float(np.asarray(PILImage.open(os.path.join(outd, f)),
                                 np.float64).mean()) for f in pngs}
    phase('train_ext_checkpoint_served', seconds=served, outputs=means,
          forwards=calls, kernel_launches=counts)
    check(sum(not raw for _, raw in calls) == 1
          and counts['float32'] == n * LAUNCHES_PER_FORWARD
          and counts['plane_stats'] == n * EXT_PLANE_PER_FORWARD,
          f'train_ext_checkpoint_served: launches {counts} for {calls}')
    check(len(pngs) >= 8 and all(np.isfinite(v) for v in means.values()),
          f'train_ext_checkpoint_served: outputs {pngs}')
    M._init_nets_cached.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    out['ext_served'] = dict(seconds=served, forwards=n,
                             trunk_per_forward=counts['float32'] / max(n, 1),
                             plane_stats_per_forward=counts['plane_stats']
                             / max(n, 1))
    return out


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
    from deepliif_tpu_torch.ops import conv_int8 as C, labeling as LB

    M.configure_device(torch.device('cuda'))   # TF32 off for the plain paths
    t0 = time.perf_counter()
    # every kernel library of the path, one nvcc each, all started together
    cuda_build.build({**FR._LIBS, **FS._LIBS, **L._LIBS, **LB._LIBS,
                      **C._LIBS})
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
    s8 = kernel_checks_conv_s8(C, rnd)
    canvases = {hw: synthetic_seg_canvas(*hw, SEED + i)
                for i, hw in enumerate(QUANT_CANVASES)}
    label = kernel_checks_label(LB, canvases)
    quant = device_quant_checks(LB, pp, canvases)
    breakdown = devquant_breakdown(
        LB, (QUANT_CANVASES[-1], canvases[QUANT_CANVASES[-1]]))
    del canvases
    torch.cuda.empty_cache()
    phase('kernel_checks', seconds=time.perf_counter() - t0)

    launches, tput, images = {}, {}, {}
    img = Image.fromarray(ihc_like_image(2 * TILE, SEED))
    K = (FR, FS, L, LB, C)
    with tempfile.TemporaryDirectory() as md:
        write_flagship_model_dir(md, dl)
        for precision, fused in (('float32', False), ('bfloat16', False),
                                 ('int8', False), ('bfloat16', True)):
            key = 'fused' if fused else precision
            launches[key], tput[key], images[key] = slice_checks(
                M, K, md, img, precision, fused, images.get('float32'))
            if key == 'float32':
                launches['devquant'] = devquant_main_path(M, K, md, img, pp)
                launches['seg_intermediate'] = seg_intermediate_checks(
                    M, K, md, img)
            if not fused and precision != 'int8':
                launches[f'seg_only {precision}'] = seg_only_checks(
                    M, K, md, img, precision)
            # one session on the card at a time, so that peak memory is
            # the next path's own
            M._init_nets_cached.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
        int8_all = {}
        for mode in ('dynamic', 'static'):      # static writes act_scales.json
            int8_all[mode] = int8_all_checks(M, K, md, img,
                                             images['float32'], mode)
            M._init_nets_cached.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
        # the serving, serialize and whole-slide entry points (float32),
        # the int8 server, the CLI's eval
        launches['serve'] = serve_checks(M, K, md, smi)
        M._init_nets_cached.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()
        launches['serve_int8'] = serve_int8_checks(M, K, md, smi)
        with tempfile.TemporaryDirectory() as root:
            launches['eval'] = eval_checks(M, K, md, root)
            M._init_nets_cached.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
            launches['serialize'] = serialize_checks(M, K, md, root)
            gc.collect()
            torch.cuda.empty_cache()
            launches['wsi'], launches['wsi_cells'] = wsi_checks(M, K, md,
                                                                root, smi)
            M._init_nets_cached.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()

        # the other model families and the attention U-Net, at full width
        with tempfile.TemporaryDirectory() as root:
            for name, model, m, input_no, seg_nets, extra in FAMILY_CASES:
                launches[name] = family_checks(M, K, root, name, model, m,
                                               input_no, seg_nets, extra)
                M._init_nets_cached.cache_clear()
                gc.collect()
                torch.cuda.empty_cache()
            launches['att_unet'] = att_unet_checks(M, K, root, dl, img)
        M._init_nets_cached.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()

        # training at float32: the statistics under autograd, one step
        # against the CPU, the flagship through the CLI's train and its
        # checkpoint served back
        from deepliif_tpu_torch.nets import vgg
        train_stats = train_stats_checks(L, rnd)
        train_step = train_step_vs_cpu(dl, vgg)
        with tempfile.TemporaryDirectory() as root:
            train = train_checks(M, K, dl, root)
        # the other families' training: one step each against the CPU,
        # then each through the CLI at full width (the flagship dir as the
        # DeepLIIFKD teacher), the Ext checkpoint served back
        train_families = train_families_vs_cpu(K, dl, vgg)
        with tempfile.TemporaryDirectory() as root:
            families = family_train_checks(M, K, dl, root, md)

    loaded = sorted(m for m in sys.modules if m == 'jax' or m == 'deepliif_tpu'
                    or m.startswith(('jax.', 'jaxlib', 'deepliif_tpu.')))
    phase('imports', jax_or_deepliif_tpu_modules=loaded,
          seconds_total=time.perf_counter() - t_start)
    check(not loaded, f'jax or deepliif_tpu was imported: {loaded}')

    # launches per batch forward on the paths of the other families, seg-only,
    # the attention U-Net, the server, serialize's parity gate, test-wsi and
    # wsi-cells: {path: (trunk kind, {kernel: launches})}
    new_paths = {path: ('float32', launches[path]) for path in (
        'ext', 'sdg', 'cyclegan', 'cyclegan_btoa', 'seg_intermediate',
        'serve', 'serialize', 'wsi', 'wsi_cells', 'eval')}
    for mode, v in launches['serve_int8'].items():
        new_paths[f'serve_int8 {mode}'] = ('int8', v)
    for precision in ('float32', 'bfloat16'):
        for weights, v in launches[f'seg_only {precision}'].items():
            new_paths[f'seg_only {precision} {weights}'] = (precision, v)
    for precision, v in launches['att_unet'].items():
        new_paths[f'att_unet {precision}'] = (precision, v)
    # training: launches per step (the KD teacher's trunk) and per forward
    # of the Ext checkpoint served
    new_paths['train_kd (per step)'] = ('float32', {
        'trunk': families['kd']['trunk_per_step'],
        'plane_stats': families['kd']['plane_stats_per_step']})
    new_paths['train_ext_checkpoint_served'] = ('float32', {
        'trunk': families['ext_served']['trunk_per_forward'],
        'plane_stats': families['ext_served']['plane_stats_per_forward']})

    def by_path(kind):
        """Launches per batch forward of the new paths that run ``kind``:
        a trunk precision, 'plane_stats' or 'conv_s8'."""
        return {path: v[kind if kind in ('plane_stats', 'conv_s8')
                        else 'trunk']
                for path, (trunk_kind, v) in new_paths.items()
                if kind in ('plane_stats', trunk_kind)
                or (kind == 'conv_s8' and v.get('conv_s8'))}

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
            'library_ms': ms[kind]['library'],
            'launches_by_path': by_path(kind),
            'per': f'one trunk conv at {TIMING_SHAPE}; launches per batch '
                   'forward of the flagship path, and of the new paths '
                   'beside them', **extra})
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
        'launches_by_path': by_path('plane_stats'),
        'training': {
            'launches_per_step': train['plane_stats_per_step'],
            'step': {k: train[k] for k in ('median_s_per_step',
                                           'peak_mem_gib')},
            'step_vs_cpu': train_step,
            'families': {name: families[name] for name in (
                'ext', 'sdg', 'cyclegan', 'kd')},
            'families_step_vs_cpu': train_families,
            'forward_backward': [
                {k: v[k] for k in ('shape', 'layout', 'kernel_ms',
                                   'plain_ms', 'bound_ms', 'dx_rel_err')}
                for v in train_stats]},
        'per': f'one norm (one call, x read once) of ({BATCH}, 64, {TILE}, '
               f'{TILE}) bf16; float32 beside it, and the largest float32 '
               'up-norm in NCHW memory; launches per batch forward, and per '
               'training step of the flagship and of each family (batch 2, '
               '512^2)'})
    big = QUANT_CANVASES[-1]
    lab = [label[(*big, conn)] for conn in (4, 8)]
    report.append({
        'name': 'label_components', 'route': 'cuda',
        'source': 'deepliif_tpu_torch/csrc/label_cc.cu',
        'replaces': 'deepliif_tpu/ops/labeling.py:410',
        'launches': launches['devquant']['label_components'],
        'max_abs_err': max(v['err'] for k, v in label.items()
                           if k != 'worst'),
        'ms': sum(v['ms'] for v in lab),
        'plain_ms': sum(v['plain_ms'] for v in lab),
        'bound_ms': sum(v['bound_ms'] for v in lab), 'bound_by': 'bytes',
        'library_ms': None, 'canvas': list(big),
        'per': 'the two launches of one quantifier call (conn 4 on the '
               'unknown mask, conn 8 on the cell mask), summed',
        'ms_by_conn': {c: v['ms'] for c, v in zip((4, 8), lab)},
        'roi_ms': sum(label[(*QUANT_CANVASES[0], c)]['ms'] for c in (4, 8)),
        'worst_case_ms': {c: v['ms'] for c, v in label['worst'].items()},
        'quantifier_seconds': {f'{h}x{w}': q['seconds']
                               for (h, w), q in quant.items()},
        'quantifier_peak_bytes_per_px': {
            f'{h}x{w}': q['peak_bytes_per_px'] for (h, w), q in quant.items()},
        'quantifier_labeling_share_of_device':
            breakdown['labeling_share_of_device']})
    tm = s8['timed']
    bd = int8_all['static']['breakdown']
    report.append({
        'name': 'conv_s8', 'route': 'cuda',
        'source': 'deepliif_tpu_torch/csrc/conv_s8.cu',
        'replaces': 'deepliif_tpu/nets/layers.py:114 (the activation '
                    'quantize :83 / :158 and XLA int8 conv_general_dilated of '
                    'conv2d, and :500 of conv_transpose2d; no TPU kernel)',
        'launches': int8_all['static']['counts']['conv_s8'],
        'launches_by_path': by_path('conv_s8'),
        'launches_dynamic': int8_all['dynamic']['counts']['conv_s8'],
        'max_pass_launches_dynamic':
            int8_all['dynamic']['counts']['s8_absmax'],
        'max_abs_err': s8['err'], 'ms': tm['kernel'],
        'plain_ms': tm['plain'], 'bound_ms': tm['bound_ms'],
        'bound_by': tm['bound_by'], 'library_ms': tm['library'],
        'library_call': 'torch._int_mm on the im2col\'d quantized operands '
                        '(int32 sums only; no quantize; F.unfold not '
                        'counted)',
        'cudnn_bf16_ms': tm['cudnn_bf16'],
        'per': f'{S8_TIMED} {S8_CALLS[0][2]} -> {S8_CALLS[0][3]}, bf16 in, '
               'static scales, the quantize included, at batch 16',
        'per_call': s8['per_call'],
        'forward_ms': s8['forward_ms'],
        'forward_bound_ms': s8['forward_bound_ms'],
        'max_pass_forward_ms': s8['absmax_forward_ms'],
        'forward_traced': {
            'conv_s8_ms': bd['groups_ms'][
                'conv_s8 (quantize, conv, max pass, split epilogue)'],
            'torch_elementwise_launches': bd['torch_elementwise_launches'],
            'torch_elementwise_ms': bd['torch_elementwise_ms'],
            'torch_native_launches': bd['torch_native_launches']}})
    print(json.dumps({'kernels': report}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
