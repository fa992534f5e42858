"""A/B of the port's kernels against the same kernels of another checkout
(for example the parent commit, unpacked with ``git archive``), on one
CUDA card: each pair timed in turns (this, other, other, this) and their
outputs compared.

- ``trunk``: conv3x3_stats float32 and bfloat16, conv3x3_stats_int8
  dynamic and static, at (16, 128, 128, 256), zero padding, with the norm
  affine and ReLU of a block's second conv; compared bit for bit.
- ``plane_stats``: one norm's statistics ([mean, var], what
  ``batch_stat_norm`` takes) at (16, 64, 512, 512) channels_last, float32
  and bfloat16, and the fused head's sums (``plane_sums``, bfloat16). A
  checkout without ``plane_mean_var`` takes the two passes of its
  ``plane_sums`` (the mean, then the sum of (x - mean)^2). Compared by the
  largest difference over the largest value of each statistic.
- ``tail_s2d``: the fused translator tail at (16, 512, 512, 64) -> 3 with
  the norm affine and ReLU, zero and reflect padding; compared bit for bit
  and by the largest difference.
- ``conv_s8``: the int8 route of ``nets.layers.conv2d`` /
  ``conv_transpose2d`` at translator down0 (static scales; dynamic ones
  take the float route past 256^2) and at the U-Net's 16 x 16 conv-transpose
  (static and dynamic), bf16 in: this tree's fused kernel (the quantize in
  its load) against the other checkout's route, whatever it is (the one
  before it: ``quant_act_static`` / ``quant_act_dynamic`` in torch, then
  its ``conv_s8`` on the int8 tensor); the weights quantized by each side's
  own ``quant.quantize_conv`` from the same float weights; bit for bit,
  with the device ms of one call by CUDA kernel (``torch.profiler``).
- ``int8_forward``: one batch-16 forward of the flagship int8 ``all``
  session with static scales (a random-weight model dir, calibrated on the
  first tiles by the first session and read by the second) in each
  checkout: timed in turns, the uint8 outputs of ``run_tiles`` compared
  byte for byte, and one forward of each traced with ``torch.profiler``:
  the launches and device ms of torch's elementwise kernels, of the int8
  conv kernels and of everything.
- ``label_components``: the two masks the device quantifier labels on the
  8192 x 8192 synthetic seg canvas (``chip_smoke.synthetic_seg_canvas``):
  conn 4 on the unknown mask, conn 8 on the cell mask; and the worst case,
  the comb of ``chip_smoke.adversarial_masks`` at 8192 x 8192, conn 4 and
  8; compared bit for bit, with the device ms of one call of each side by
  CUDA kernel (``torch.profiler``; the labeling's passes).

    git archive <commit> | tar -x -C build/other
    python3 experiments/torch_kernel_ab.py --other build/other \
        [--kernels trunk,plane_stats,tail_s2d,conv_s8,int8_forward,
                   label_components]

The other checkout's ``deepliif_tpu_torch`` is imported under another name
through its own wrappers, so its kernels are built from its own sources
(into its own ``_build``) and called with its own signatures. Prints one
JSON line per kernel, then the card's name and power limit. Imports
nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def import_other(root):
    """The other checkout's ``deepliif_tpu_torch`` modules that hold
    kernels or feed them (fused_resblock, layers, fused_stages, labeling,
    quant), imported from the package ``other_port``."""
    pkg = os.path.join(os.path.abspath(root), 'deepliif_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        'other_port', os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules['other_port'] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f'other_port.{m}') for m in (
        'ops.fused_resblock', 'nets.layers', 'labs.fused_stages',
        'ops.labeling', 'ops.quant', 'models'))


def trunk_cases(FR, other, rnd):
    """{name: (this, other)} of the trunk kernels; each returns (y, stats)."""
    s, h, w, c = smoke.TIMING_SHAPE
    x32 = rnd(s, h, w, c)
    w32 = rnd(3, 3, c, c, std=0.02)
    sc, bi = rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    aff = dict(padding='zero', in_scale=sc, in_bias=bi, in_relu=True)
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        x, wt = x32.to(dt), w32.to(dt)
        cases[f'conv3x3_stats {dt}'] = tuple(
            (lambda m=m, x=x, wt=wt: m.conv3x3_stats(x, wt, **aff))
            for m in (FR, other))
    xb = x32.to(torch.bfloat16)
    wq, ws = rnd.int8_weights(c)
    ones = torch.ones(c, device='cuda')
    for mode, kw in (('dynamic', dict(dynamic=True)),
                     ('static', dict(inv_a=ones))):
        cases[f'conv3x3_stats_int8 {mode}'] = tuple(
            (lambda m=m, kw=kw: m.conv3x3_stats_int8(xb, wq, ws, **kw, **aff))
            for m in (FR, other))
    return cases, list(smoke.TIMING_SHAPE)


def mean_var(L):
    """The checkout's statistics of one norm, (S, 2, C) [mean, var]."""
    if hasattr(L, 'plane_mean_var'):
        return L.plane_mean_var

    def two_pass(x):
        n = x.shape[2] * x.shape[3]
        mean = L.plane_sums(x)[:, 0] / n
        return torch.stack([mean, L.plane_sums(x, mean)[:, 1] / n], dim=1)
    return two_pass


def plane_cases(L, other, rnd):
    shape = (smoke.BATCH, 64, smoke.TILE, smoke.TILE)
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        x = (rnd.big(shape[0], shape[2], shape[3], shape[1], dtype=dt)
             + 0.5).permute(0, 3, 1, 2)
        cases[f'plane_stats mean_var {dt}'] = tuple(
            (lambda f=mean_var(m), x=x: f(x)) for m in (L, other))
        if dt == torch.bfloat16:
            cases[f'plane_stats sums {dt}'] = tuple(
                (lambda m=m, x=x: m.plane_sums(x)) for m in (L, other))
    return cases, list(shape)


def tail_cases(FS, other, rnd):
    s, h, w, cin = smoke.TAIL_SHAPE
    x = rnd.big(*smoke.TAIL_SHAPE)
    wt = rnd(7, 7, cin, smoke.TAIL_COUT, std=0.02).to(torch.bfloat16)
    b = rnd(smoke.TAIL_COUT, std=0.1).to(torch.bfloat16)
    aff = dict(in_scale=rnd(s, cin, std=0.1, mean=1.0),
               in_bias=rnd(s, cin, std=0.1), in_relu=True)
    cases = {}
    for padding in ('zero', 'reflect'):
        cases[f'tail_s2d {padding}'] = tuple(
            (lambda m=m, padding=padding: m.tail_s2d_fused(
                x, wt, b, padding=padding, **aff)) for m in (FS, other))
    return cases, list(smoke.TAIL_SHAPE)


def s8_cases(L, Q, other_l, other_q, rnd):
    """{name: (this, other)} of the int8 conv route (layers.conv2d /
    conv_transpose2d with a quantized weight) at two flagship calls."""
    cases = {}
    for name, modes in (('translator down0', ('static',)),
                        ('unet up 16', ('static', 'dynamic'))):
        _, kind, shape, cout, k, op = next(
            c for c in smoke.S8_CALLS if c[0] == name)
        x = rnd.big(*shape).permute(0, 3, 1, 2)   # channels_last memory
        w = rnd(k, k, shape[3], cout, std=0.02)    # HWIO
        scale = x.float().abs().amax(dim=(0, 2, 3)).cpu().tolist()
        for mode in modes:
            sc = scale if mode == 'static' else None
            pair = []
            for lay, q in ((L, Q), (other_l, other_q)):
                qc = q.quantize_conv(w, w, sc, torch.bfloat16)
                if kind == 'conv':
                    pair.append(lambda lay=lay, qc=qc, x=x: lay.conv2d(
                        x, qc, None, 2, 1))
                else:
                    pair.append(lambda lay=lay, qc=qc, x=x, op=op:
                                lay.conv_transpose2d(x, qc, None, 2, 1, op))
            cases[f'conv_s8 {name} {mode} {list(shape)} -> {cout}'] = \
                tuple(pair)
    return cases, None


def forward_trace(fn):
    """Launches and device ms of one call of ``fn`` (after a warm-up) by
    group: torch's elementwise kernels, the int8 conv kernels (``conv_s8``),
    all device kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {'torch_elementwise': lambda k: 'at::native' in k and
              'elementwise' in k,
              'conv_s8': lambda k: 'conv_s8' in k,
              'all': lambda k: True}
    out = {}
    for g, pred in groups.items():
        hit = [e for e in dev if pred(e.name)]
        out[g] = {'launches': len(hit), 'ms': sum(
            (e.time_range.end - e.time_range.start) / 1e3 for e in hit)}
    return out


def forward_cases(M, other_m, md):
    """{name: (this, other)}: one batch forward of each checkout's int8
    'all' static session on the same model dir and tiles."""
    import numpy as np
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.utils import checkpoints as ck
    smoke.write_flagship_model_dir(md, dl, ck)
    big = np.asarray(smoke.ihc_like_image(2 * smoke.TILE, smoke.SEED))
    rng = np.random.default_rng(smoke.SEED + 1)
    origins = rng.integers(0, smoke.TILE + 1, (smoke.BATCH, 2))
    batch = np.stack([big[y:y + smoke.TILE, x:x + smoke.TILE]
                      for y, x in origins])
    kw = dict(device='cuda', max_batch=smoke.BATCH, precision='int8',
              int8_calibrate=True)
    sessions = []
    for m in (M, other_m):
        session = m.init_nets(md, **kw)
        out = session.run_tiles(batch)   # the first calibrates (and saves)
        sessions.append((session, out))
    same = all(np.array_equal(sessions[0][1][k], sessions[1][1][k])
               for k in sessions[0][1])
    tiles = torch.from_numpy(batch)
    fns = tuple((lambda s=s: s.forward(tiles)) for s, _ in sessions)
    return {'int8_forward static': fns}, same


def label_cases(LB, other):
    h, w = smoke.QUANT_CANVASES[-1]
    _, seg, _ = smoke.synthetic_seg_canvas(h, w, smoke.SEED + 1)
    masks = {f'conn {c}': (fg, c)
             for c, fg in smoke.label_masks(LB, seg).items()}
    comb = torch.from_numpy(
        smoke.adversarial_masks(h, w, smoke.SEED)['comb']).cuda()
    masks.update({f'comb conn {c}': (comb, c) for c in (4, 8)})
    cases = {}
    for name, (fg, conn) in masks.items():
        cases[f'label_components {name}'] = tuple(
            (lambda m=m, fg=fg, c8=conn == 8: m.label_components(fg, conn8=c8))
            for m in (LB, other))
    return cases, [h, w]


def by_kernel(fn):
    """Device ms of one call of ``fn`` by CUDA kernel name
    (``torch.profiler``), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, 'device_time_total', None)
        if us is None:
            us = getattr(ev, 'cuda_time_total', 0)
        found = re.search(r'(\w+_kernel)', ev.key)
        if us and found:
            out[found.group(1)] = out.get(found.group(1), 0) + us / 1e3
    return out


def compare(a, b):
    """Equality and the largest difference (absolute, and over the largest
    |value| of each statistic) of two outputs or output tuples."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    out = {'equal': all(bool(torch.equal(u, v)) for u, v in zip(a, b))}
    out['max_abs_diff'] = [(u.double() - v.double()).abs().max().item()
                           for u, v in zip(a, b)]
    if a[0].dim() == 3:                          # (S, 2, C) statistics
        out['max_rel_diff'] = smoke.stats_rel(a[0], b[0])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--other', required=True,
                    help='root of the other checkout')
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--kernels',
                    default='trunk,plane_stats,tail_s2d,conv_s8,'
                            'int8_forward,label_components',
                    help='comma list of trunk, plane_stats, tail_s2d, '
                         'conv_s8, int8_forward, label_components')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the kernel A/B needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.labs import fused_stages as FS
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.ops import fused_resblock as FR
    from deepliif_tpu_torch.ops import labeling as LB, quant as Q

    M.configure_device(torch.device('cuda'))
    other_fr, other_l, other_fs, other_lb, other_q, other_m = import_other(
        args.other)
    rnd = smoke.Rand(smoke.SEED)
    makers = {'trunk': lambda: trunk_cases(FR, other_fr, rnd),
              'plane_stats': lambda: plane_cases(L, other_l, rnd),
              'tail_s2d': lambda: tail_cases(FS, other_fs, rnd),
              'conv_s8': lambda: s8_cases(L, Q, other_l, other_q, rnd),
              'label_components': lambda: label_cases(LB, other_lb)}
    for group in args.kernels.split(','):
        if group == 'int8_forward':
            with tempfile.TemporaryDirectory() as md:
                cases, same = forward_cases(M, other_m, md)
                for name, (this, that) in cases.items():
                    runs, ms = smoke.in_turns({'this': this, 'other': that},
                                              2)
                    print(json.dumps({
                        'kernel': name, 'runs_ms': runs,
                        'this_ms': ms['this'], 'other_ms': ms['other'],
                        'outputs_byte_equal': same,
                        'trace': {'this': forward_trace(this),
                                  'other': forward_trace(that)}}),
                          flush=True)
                del cases
            torch.cuda.empty_cache()
            continue
        cases, shape = makers[group]()
        for name, (this, that) in cases.items():
            runs, ms = smoke.in_turns({'this': this, 'other': that},
                                      args.iters)
            got = compare(this(), that())
            torch.cuda.synchronize()
            if group in ('label_components', 'conv_s8'):
                got['pass_ms'] = {'this': by_kernel(this),
                                  'other': by_kernel(that)}
            print(json.dumps({'kernel': name, 'shape': shape,
                              'runs_ms': runs, 'this_ms': ms['this'],
                              'other_ms': ms['other'], **got}), flush=True)
        del cases
        torch.cuda.empty_cache()
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
