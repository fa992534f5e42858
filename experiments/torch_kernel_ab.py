"""A/B of the port's trunk kernels against the same kernels of another
checkout (for example the parent commit, unpacked with ``git archive``), on
one CUDA card: each pair timed in turns (this, other, other, this) at
(16, 128, 128, 256), zero padding, with the norm affine and ReLU of a
block's second conv, and their outputs compared bit for bit.

    git archive <commit> | tar -x -C build/other
    python3 experiments/torch_kernel_ab.py --other build/other

The other checkout's ``deepliif_tpu_torch`` is imported under another name
through its own wrappers, so its kernels are built from its own sources
(into its own ``_build``) and called with its own signatures. Prints one
JSON line per kernel (float32, bfloat16, int8 dynamic and static), then the
card's name and power limit. Imports nothing of jax or deepliif_tpu.
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
    """The other checkout's ``deepliif_tpu_torch.ops.fused_resblock``,
    imported as the package ``other_port``."""
    pkg = os.path.join(os.path.abspath(root), 'deepliif_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        'other_port', os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules['other_port'] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module('other_port.ops.fused_resblock')


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--other', required=True,
                    help='root of the other checkout')
    ap.add_argument('--iters', type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the kernel A/B needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.ops import fused_resblock as FR

    M.configure_device(torch.device('cuda'))
    other = import_other(args.other)
    FR.build()
    other.build()
    rnd = smoke.Rand(smoke.SEED)
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

    for name, (this, that) in cases.items():
        runs, ms = smoke.in_turns({'this': this, 'other': that}, args.iters)
        y1, st1 = this()
        y2, st2 = that()
        torch.cuda.synchronize()
        print(json.dumps({'kernel': name, 'shape': list(smoke.TIMING_SHAPE),
                          'runs_ms': runs, 'this_ms': ms['this'],
                          'other_ms': ms['other'],
                          'y_equal': bool(torch.equal(y1, y2)),
                          'max_abs_dy': (y1.float() - y2.float()).abs().max()
                          .item(),
                          'stats_equal': bool(torch.equal(st1, st2))}),
              flush=True)
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
