"""A/B of the port's trunk kernels against the same kernels built from another
checkout (for example the parent commit, unpacked with ``git archive``), on
one CUDA card: each pair timed in turns (this, other, other, this, at
(16, 128, 128, 256), zero padding, with the norm affine and ReLU of a
block's second conv), and their outputs compared bit for bit.

    git archive <commit> | tar -x -C build/other
    python3 experiments/torch_kernel_ab.py --other build/other

The other checkout's libraries are built from its ``deepliif_tpu_torch/csrc``
with this tree's nvcc flags; a kernel whose entry point the other build
lacks is skipped. Prints one JSON line per kernel, then the card's name and
power limit. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def build_other(root, out_dir):
    """{library name: ctypes handle} built from ``root``'s csrc sources."""
    from deepliif_tpu_torch.ops import cuda_build
    csrc = os.path.join(root, 'deepliif_tpu_torch', 'csrc')
    procs = {}
    for name in ('conv3x3_stats', 'conv3x3_stats_int8'):
        src = os.path.join(csrc, f'{name}.cu')
        if os.path.exists(src):
            procs[name] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o',
                 os.path.join(out_dir, f'{name}.so'), src])
    for name, proc in procs.items():
        if proc.wait() != 0:
            sys.exit(f'nvcc failed on the other checkout\'s {name}.cu')
    return {name: ctypes.CDLL(os.path.join(out_dir, f'{name}.so'))
            for name in procs}


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
    FR.build()
    other = build_other(args.other, tempfile.mkdtemp())
    p, i = ctypes.c_void_p, ctypes.c_int
    rnd = smoke.Rand(smoke.SEED)
    s, h, w, c = smoke.TIMING_SHAPE
    x32 = rnd(s, h, w, c)
    w32 = rnd(3, 3, c, c, std=0.02)
    sc, bi = rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    n_tiles = FR._lib().conv3x3_stats_num_tiles(h, w)

    def scratch(x):
        return (torch.empty_like(x),
                torch.empty((s, n_tiles, 2, c), device='cuda'),
                torch.empty((s, 2, c), device='cuda'))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    cases = {}
    lib = other.get('conv3x3_stats')
    for dt, sym in ((torch.float32, 'conv3x3_stats_f32'),
                    (torch.bfloat16, 'conv3x3_stats_bf16')):
        if lib is None or not hasattr(lib, sym):
            continue
        fn = getattr(lib, sym)
        fn.argtypes = [p] * 7 + [i] * 7 + [p]
        x, wt = x32.to(dt), w32.to(dt)
        y, part, st = scratch(x)

        def run_other(fn=fn, x=x, wt=wt, y=y, part=part, st=st):
            err = fn(x.data_ptr(), wt.data_ptr(), sc.data_ptr(),
                     bi.data_ptr(), y.data_ptr(), part.data_ptr(),
                     st.data_ptr(), s, h, w, c, 0, 1, 1, stream())
            if err:
                sys.exit(f'{sym} of the other checkout failed: {err}')
            return y, st

        cases[f'conv3x3_stats {dt}'] = (
            lambda x=x, wt=wt: FR.conv3x3_stats(
                x, wt, padding='zero', in_scale=sc, in_bias=bi, in_relu=True),
            run_other)
    lib8 = other.get('conv3x3_stats_int8')
    if lib8 is not None:
        lib8.conv3x3_stats_int8.argtypes = [p] * 10 + [i] * 9 + [p]
        xb = x32.to(torch.bfloat16)
        wq, ws = rnd.int8_weights(c)
        wp = FR.pack_w_int8(wq)
        y, part, st = scratch(xb)
        m_raw = torch.empty((s, h // FR.CHUNK_ROWS), device='cuda')

        def run_other8():
            err = lib8.conv3x3_stats_int8(
                xb.data_ptr(), wp.data_ptr(), ws.data_ptr(), None,
                sc.data_ptr(), bi.data_ptr(), y.data_ptr(), m_raw.data_ptr(),
                part.data_ptr(), st.data_ptr(), s, h, w, c, FR.CHUNK_ROWS, 0,
                1, 1, 1, stream())
            if err:
                sys.exit(f'conv3x3_stats_int8 of the other checkout failed: '
                         f'{err}')
            return y, st

        cases['conv3x3_stats_int8 dynamic'] = (
            lambda: FR.conv3x3_stats_int8(xb, wq, ws, dynamic=True,
                                          padding='zero', in_scale=sc,
                                          in_bias=bi, in_relu=True),
            run_other8)

    for name, (this, that) in cases.items():
        runs, ms = smoke.in_turns({'this': this, 'other': that}, args.iters)
        y1, st1 = this()
        y2, st2 = that()
        torch.cuda.synchronize()
        print(json.dumps({'kernel': name, 'shape': list(smoke.TIMING_SHAPE),
                          'runs_ms': runs, 'this_ms': ms['this'],
                          'other_ms': ms['other'],
                          'y_equal': bool(torch.equal(y1, y2)),
                          'stats_equal': bool(torch.equal(st1, st2))}),
              flush=True)
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
