"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels from this checkout, checks each against its plain PyTorch version
at the shapes of the main path, then drives flagship DeepLIIF f32 inference
(4 x resnet_9blocks + 5 x unet_512, ngf 64, 512^2 tiles, random weights from
a seed) end to end through the port's user entry points.

    python3 chip_smoke.py            # needs one CUDA card; exits 0 on success

Prints one line per phase, then the kernel report as a JSON line, the card's
name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before that line. There is no CPU path.
"""

from __future__ import annotations

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
# Kernel vs plain float32 tolerances. y: the repo's f32 layer tolerance
# (1e-4 absolute). stats: max |delta| over the largest |stat| of its kind,
# 1e-4, because the two versions sum 16384 float32 terms per (sample,
# channel) in different orders and sum(y) cancels.
Y_TOL, STATS_TOL = 1e-4, 1e-4
# one full-width translator, kernel trunk vs plain trunk, on the tanh output:
# 18 convs and 18 norms in the chain, each within the layer tolerance
TRANSLATOR_TOL = 1e-4
KERNEL_SHAPE = (4, 128, 128, 256)    # flagship trunk: (S, 512/4, 512/4, 4*64)
TIMING_SHAPE = (16, 128, 128, 256)   # the same at batch 16
LAUNCHES_PER_FORWARD = 4 * 9 * 2     # nets x blocks x convs


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


def stats_rel(got, ref):
    return max(((got[:, q] - ref[:, q]).abs().max()
                / ref[:, q].abs().max()).item() for q in range(2))


def kernel_checks(FR):
    gen = torch.Generator().manual_seed(SEED)
    s, h, w, c = KERNEL_SHAPE

    def rand(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen)).cuda()

    x = rand(*KERNEL_SHAPE)
    wt = rand(3, 3, c, c, std=0.02)
    sc, bi = rand(s, c, std=0.1, mean=1.0), rand(s, c, std=0.1)
    worst = 0.0
    for padding in ('zero', 'reflect'):
        for affine in (False, True):
            kw = dict(padding=padding, in_relu=affine,
                      in_scale=sc if affine else None,
                      in_bias=bi if affine else None)
            y, st = FR.conv3x3_stats(x, wt, **kw)
            y_ref, st_ref = FR.conv3x3_stats_reference(x, wt, **kw)
            torch.cuda.synchronize()
            err = (y - y_ref).abs().max().item()
            rel = stats_rel(st, st_ref)
            worst = max(worst, err)
            phase('kernel_vs_plain', shape=list(KERNEL_SHAPE), padding=padding,
                  affine_relu=affine, max_abs_err_y=err, stats_rel_err=rel)
            check(err < Y_TOL, f'y error {err} >= {Y_TOL}')
            check(rel < STATS_TOL, f'stats error {rel} >= {STATS_TOL}')
            y2, st2 = FR.conv3x3_stats(x, wt, **kw)
            check(torch.equal(y, y2) and torch.equal(st, st2),
                  'two launches differ')
            kw1 = dict(kw, in_scale=sc[1:2].contiguous() if affine else None,
                       in_bias=bi[1:2].contiguous() if affine else None)
            y1, st1 = FR.conv3x3_stats(x[1:2].contiguous(), wt, **kw1)
            check(torch.equal(y1[0], y[1]) and torch.equal(st1[0], st[1]),
                  'sample alone differs from the sample in the batch')
    phase('kernel_deterministic', two_launches_byte_equal=True,
          batch_invariant=True)

    blocks = [{'w1': rand(3, 3, c, c, std=0.02), 'w2': rand(3, 3, c, c, std=0.02),
               'norm1': {'scale': rand(c, std=0.02, mean=1.0), 'bias': rand(c, std=0.01)},
               'norm2': {'scale': rand(c, std=0.02, mean=1.0), 'bias': rand(c, std=0.01)}}
              for _ in range(9)]
    for padding in ('zero', 'reflect'):
        got = FR.resblock_chain(x, blocks, padding=padding)
        want = FR.resblock_chain_reference(x, blocks, padding=padding)
        err = (got - want).abs().max().item()
        phase('resblock_chain_vs_plain', blocks=9, padding=padding,
              max_abs_err=err)
        check(err < Y_TOL, f'9-block chain error {err} >= {Y_TOL}')

    xt = torch.randn(TIMING_SHAPE, generator=gen).cuda()
    times = {'kernel': [], 'plain': []}
    for name in ('plain', 'kernel', 'kernel', 'plain'):
        fn = FR.conv3x3_stats if name == 'kernel' else FR.conv3x3_stats_reference
        times[name].append(cuda_ms(lambda: fn(xt, wt, padding='zero'), 10))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    gflop = 2 * np.prod(TIMING_SHAPE) * c * 9 / 1e9
    phase('kernel_timing', shape=list(TIMING_SHAPE), runs_ms=times,
          kernel_ms=ms['kernel'], plain_ms=ms['plain'],
          kernel_tflops=gflop / ms['kernel'], plain_tflops=gflop / ms['plain'])
    return worst, ms


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


def slice_checks(M, dl, ck, FR):
    from PIL import Image

    with tempfile.TemporaryDirectory() as md:
        t0 = time.perf_counter()
        write_flagship_model_dir(md, dl, ck)
        session = M.init_nets(md, device='cuda', max_batch=BATCH)
        phase('model_dir', seconds=time.perf_counter() - t0, ngf=session.d.ngf,
              net_g=session.d.net_g, net_gs=session.d.net_gs)

        img = Image.fromarray(ihc_like_image(2 * TILE, SEED))
        forwards = []
        run_batch = session.forward
        session.forward = lambda *a, **k: forwards.append(1) or run_batch(*a, **k)

        # the main path, through the user entry point: tiler, run_tiles,
        # stitch, host postprocess
        torch.cuda.synchronize()
        FR.conv3x3_stats.launches = 0
        t0 = time.perf_counter()
        images, scoring = M.infer_modalities(img, TILE, md, device='cuda',
                                             max_batch=BATCH)
        torch.cuda.synchronize()
        launches = FR.conv3x3_stats.launches
        seconds = time.perf_counter() - t0
        n_forwards = len(forwards)
        phase('main_path', seconds=seconds, batch_forwards=n_forwards,
              kernel_launches=launches, outputs=sorted(images),
              scoring=scoring)
        check(n_forwards >= 1, 'no batch forward ran')
        check(launches == LAUNCHES_PER_FORWARD * n_forwards,
              f'{launches} kernel launches for {n_forwards} forwards')
        want = {'mod1-Hema', 'mod2-DAPI', 'mod3-Lap2', 'mod4-Marker', 'Seg',
                'SegOverlaid', 'SegRefined'}
        check(set(images) == want, f'outputs {sorted(images)}')
        for k, im in images.items():
            a = np.asarray(im)
            check(a.shape == (2 * TILE, 2 * TILE, 3) and a.dtype == np.uint8,
                  f'{k}: {a.shape} {a.dtype}')
        check({'num_total', 'num_pos', 'num_neg', 'percent_pos'} <= set(scoring),
              f'scoring keys {sorted(scoring)}')

        images2, scoring2 = M.infer_modalities(img, TILE, md, device='cuda',
                                               max_batch=BATCH)
        same = all(np.array_equal(np.asarray(images[k]), np.asarray(images2[k]))
                   for k in images) and scoring == scoring2
        phase('run_to_run', byte_equal=same)
        check(same, 'two runs differ')

        # one full-width translator: kernel trunk vs the plain trunk composed
        # from the module's public pieces
        net = session.nets.G[0]
        tiles = np.stack([np.asarray(img)[y:y + TILE, x:x + TILE]
                          for y, x in ((0, 0), (TILE, TILE))])
        xin = (torch.from_numpy(tiles).cuda().float() / 127.5 - 1.0).permute(0, 3, 1, 2)
        with torch.no_grad():
            got = net(xin)
            want_t = net.tail(FR.resblock_chain_reference(
                net.head(xin), net.trunk_blocks(), padding=net.padding_type))
        err = (got - want_t).abs().max().item()
        phase('translator_vs_plain_trunk', shape=list(got.shape),
              finite=bool(torch.isfinite(got).all()), max_abs_err=err)
        check(bool(torch.isfinite(got).all()), 'non-finite translator output')
        check(err < TRANSLATOR_TOL, f'translator error {err} >= {TRANSLATOR_TOL}')

        # throughput and per-net time at batch 16
        rng = np.random.default_rng(SEED + 1)
        big = np.asarray(img)
        origins = rng.integers(0, 2 * TILE - TILE + 1, (BATCH, 2))
        batch = np.stack([big[y:y + TILE, x:x + TILE] for y, x in origins])
        session.run_tiles(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            session.run_tiles(batch)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        phase('throughput', batch=BATCH, tiles_per_s=BATCH * iters / seconds,
              seconds_per_batch=seconds / iters, peak_mem_bytes=peak,
              peak_mem_gib=peak / 2 ** 30)

        xb = (torch.from_numpy(batch).cuda().float() / 127.5 - 1.0).permute(0, 3, 1, 2)
        with torch.no_grad():
            ms = {'translator': cuda_ms(lambda: net(xb), 2),
                  'translator_trunk': cuda_ms(
                      lambda: net.trunk(net.head(xb)), 2),
                  'seg_unet_512': cuda_ms(lambda: session.nets.GS[0](xb), 2)}
        phase('per_net_ms', batch=BATCH, **ms,
              ensemble_estimate_ms=4 * ms['translator'] + 5 * ms['seg_unet_512'])
        session.forward = run_batch
        return launches


def main():
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is false: '
          'chip_smoke.py needs a CUDA card')
    smi = nvidia_smi()
    phase('device', nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())

    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.ops import cuda_build, fused_resblock as FR
    from deepliif_tpu_torch.utils import checkpoints as ck

    M.configure_device(torch.device('cuda'))   # TF32 off for the plain f32 path
    t0 = time.perf_counter()
    FR.build()
    phase('build', seconds=time.perf_counter() - t0,
          nvcc_seconds=cuda_build.build_seconds)

    max_err, ms = kernel_checks(FR)
    launches = slice_checks(M, dl, ck, FR)
    check('jax' not in sys.modules, 'jax was imported')

    print(json.dumps({'kernels': [{
        'name': 'conv3x3_stats', 'route': 'cuda',
        'source': 'deepliif_tpu_torch/csrc/conv3x3_stats.cu',
        'replaces': 'deepliif_tpu/ops/fused_resblock.py:158',
        'launches': launches, 'max_abs_err': max_err,
        'ms': ms['kernel'], 'plain_ms': ms['plain']}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
