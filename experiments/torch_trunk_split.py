"""Where one call of the port's float32 and int8 trunk kernels spends its
device time, kernel by kernel (weight pack, int8 max and quantize passes,
the wgmma conv, the stats reduction), on one CUDA card at (16, 128, 128,
256), zero padding, with the norm affine and ReLU of a block's second conv.

    python3 experiments/torch_trunk_split.py

Traces ``--iters`` calls of each with torch.profiler (CUDA activity) and
prints one JSON line per call kind: the device time per call of each
kernel name, their sum, and the calls' CUDA-event time beside it; then the
card's name and power limit. A trace with no device time is reported as
such. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the trunk split needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.ops import fused_resblock as FR

    M.configure_device(torch.device('cuda'))
    FR.build()
    rnd = smoke.Rand(smoke.SEED)
    s, h, w, c = smoke.TIMING_SHAPE
    x = rnd(s, h, w, c)
    wt = rnd(3, 3, c, c, std=0.02)
    sc, bi = rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    aff = dict(padding='zero', in_scale=sc, in_bias=bi, in_relu=True)
    xb = x.to(torch.bfloat16)
    wq, ws = rnd.int8_weights(c)
    ones = torch.ones(c, device='cuda')
    calls = {
        'conv3x3_stats float32': lambda: FR.conv3x3_stats(x, wt, **aff),
        'conv3x3_stats_int8 dynamic': lambda: FR.conv3x3_stats_int8(
            xb, wq, ws, dynamic=True, **aff),
        'conv3x3_stats_int8 static': lambda: FR.conv3x3_stats_int8(
            xb, wq, ws, ones, **aff)}
    for name, fn in calls.items():
        event_ms = smoke.cuda_ms(fn, args.iters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        per = {}
        for ev in prof.key_averages():
            t = getattr(ev, 'device_time_total', None)
            if t is None:
                t = getattr(ev, 'cuda_time_total', 0.0)
            if t and str(getattr(ev, 'device_type', '')).endswith('CUDA'):
                per[ev.key] = t / 1e3 / args.iters      # ms per call
        print(json.dumps({
            'call': name, 'shape': list(smoke.TIMING_SHAPE),
            'event_ms': event_ms,
            'kernels_ms': per if per else 'no device time in the trace',
            'sum_ms': sum(per.values()) if per else None}), flush=True)
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
