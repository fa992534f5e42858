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

    git archive <commit> | tar -x -C build/other
    python3 experiments/torch_kernel_ab.py --other build/other \
        [--kernels trunk,plane_stats,tail_s2d]

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
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def import_other(root):
    """The other checkout's ``deepliif_tpu_torch`` modules that hold
    kernels (fused_resblock, layers, fused_stages), imported from the
    package ``other_port``."""
    pkg = os.path.join(os.path.abspath(root), 'deepliif_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        'other_port', os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules['other_port'] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f'other_port.{m}') for m in (
        'ops.fused_resblock', 'nets.layers', 'labs.fused_stages'))


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


def compare(a, b):
    """Equality and the largest difference (absolute, and over the largest
    |value| of each statistic) of two outputs or output tuples."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    out = {'equal': all(bool(torch.equal(u, v)) for u, v in zip(a, b))}
    out['max_abs_diff'] = [(u.float() - v.float()).abs().max().item()
                           for u, v in zip(a, b)]
    if a[0].dim() == 3:                          # (S, 2, C) statistics
        out['max_rel_diff'] = smoke.stats_rel(a[0], b[0])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--other', required=True,
                    help='root of the other checkout')
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--kernels', default='trunk,plane_stats,tail_s2d',
                    help='comma list of trunk, plane_stats, tail_s2d')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the kernel A/B needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.labs import fused_stages as FS
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.ops import fused_resblock as FR

    M.configure_device(torch.device('cuda'))
    other_fr, other_l, other_fs = import_other(args.other)
    rnd = smoke.Rand(smoke.SEED)
    makers = {'trunk': lambda: trunk_cases(FR, other_fr, rnd),
              'plane_stats': lambda: plane_cases(L, other_l, rnd),
              'tail_s2d': lambda: tail_cases(FS, other_fs, rnd)}
    for group in args.kernels.split(','):
        cases, shape = makers[group]()
        for name, (this, that) in cases.items():
            runs, ms = smoke.in_turns({'this': this, 'other': that},
                                      args.iters)
            got = compare(this(), that())
            torch.cuda.synchronize()
            print(json.dumps({'kernel': name, 'shape': shape,
                              'runs_ms': runs, 'this_ms': ms['this'],
                              'other_ms': ms['other'], **got}), flush=True)
        del cases
        torch.cuda.empty_cache()
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
