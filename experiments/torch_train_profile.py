"""Where one training step of the full-width DeepLIIF flagship spends its
device time on one CUDA card: 4 resnet_9blocks + 5 unet_512 + 9 n_layers-4
discriminators + VGG19 on the modalities, ngf = ndf = 64, 512^2, batch 2,
dropout on, float32 with TF32 off, random weights and batch from a seed.

    python3 experiments/torch_train_profile.py [--batch 2] [--steps 5]

Runs ``--steps`` steps (the first a warm-up) timed with CUDA events and
the host clock, then traces one more with torch.profiler (CPU and CUDA
activity) and prints JSON lines: the steps' seconds and peak memory; the
traced step's device busy time against its host wall time, the top 15
torch ops by self device time and the top 15 kernels, the statistics'
share (the ``plane_stats`` kernels of the forward, and the Function's
backward, the elementwise pass of ``layers._PlaneMeanVar.backward``), the
convolution kernels' share, and the optimizer's; then the card's name and
power limit. A trace with no device time is reported as such. Imports
nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402

PLANE_KERNELS = ('plane_chunk_kernel', 'plane_chunk_nchw_kernel',
                 'plane_merge_kernel')


def _busy_ms(events):
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--steps', type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the training profile needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L, vgg
    from deepliif_tpu_torch.ops import cuda_build

    dev = torch.device('cuda')
    M.configure_device(dev)
    cuda_build.build(L._LIBS)
    backward = L._PlaneMeanVar.backward

    def traced_backward(ctx, g):
        with record_function('plane_stats_backward'):
            return backward(ctx, g)
    L._PlaneMeanVar.backward = staticmethod(traced_backward)

    d = dl.DeepLIIFDef()
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    state = dl.create_train_state(d, opt, 1, smoke.SEED, dev)
    step = dl.make_train_step(d, vgg.VGG19Features().to(dev))
    arrays = smoke.train_batch_arrays(smoke.TILE, args.batch,
                                      d.modalities_no, smoke.SEED)
    batch = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in arrays.items()}
    rng = torch.Generator(dev).manual_seed(smoke.SEED + 1)
    for name in ('g_opt', 'd_opt'):
        opt_step = getattr(state, name).step

        def traced_step(*a, _step=opt_step, _name=name, **kw):
            with record_function(f'optimizer_{_name}'):
                return _step(*a, **kw)
        getattr(state, name).step = traced_step

    torch.cuda.reset_peak_memory_stats()
    host_s, dev_ms = [], []
    for _ in range(args.steps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        step(state, batch, rng)
        b.record()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        dev_ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({'phase': 'train_steps', 'batch': args.batch,
                      'size': smoke.TILE, 'host_seconds': host_s,
                      'event_ms': dev_ms,
                      'median_s_per_step': float(np.median(host_s[1:])),
                      'peak_mem_gib': peak / 2 ** 30,
                      'params': sum(p.numel() for p in
                                    state.nets.parameters())}), flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, rng)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events without the ranges of annotations (the record_function
    # ranges above, torch's Optimizer.step), which span kernels counted
    notes = ('plane_stats_backward', 'optimizer_g_opt', 'optimizer_d_opt')
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in notes and not e.name.startswith('Optimizer.')]
    if not events:
        print(json.dumps({'phase': 'train_step_profile',
                          'error': 'no device time in the trace'}))
        print(smoke.nvidia_smi())
        return

    def ms(e):
        return (e.time_range.end - e.time_range.start) / 1e3
    device_ms = sum(ms(e) for e in events)
    by_kernel = {}
    for e in events:
        by_kernel[e.name[:100]] = by_kernel.get(e.name[:100], 0.0) + ms(e)
    by_op = {}
    for ev in prof.key_averages():
        self_us = getattr(ev, 'self_device_time_total', 0)
        if self_us > 0 and ev.device_type == torch.autograd.DeviceType.CPU:
            by_op[ev.key] = by_op.get(ev.key, 0.0) + self_us / 1e3
    stats_fwd = sum(ms(e) for e in events
                    if any(k in e.name for k in PLANE_KERNELS))
    ranges = {ev.key: getattr(ev, 'device_time_total', 0) / 1e3
              for ev in prof.key_averages()
              if ev.key in ('plane_stats_backward', 'optimizer_g_opt',
                            'optimizer_d_opt')}
    stats_bwd = ranges.get('plane_stats_backward', 0.0)
    optim = ranges.get('optimizer_g_opt', 0.0) + ranges.get(
        'optimizer_d_opt', 0.0)
    conv = sum(v for k, v in by_kernel.items()
               if any(s in k.lower() for s in ('conv', 'cudnn', 'sm90',
                                               'sm80', 'implicit', 'gemm',
                                               'wgrad', 'dgrad')))

    def top(dct, n=15):
        return dict(sorted(dct.items(), key=lambda kv: -kv[1])[:n])
    print(json.dumps({
        'phase': 'train_step_profile', 'host_wall_ms': wall_ms,
        'device_busy_ms': _busy_ms(events),
        'device_busy_share': _busy_ms(events) / wall_ms,
        'device_ms_summed': device_ms, 'device_events': len(events),
        'plane_stats_forward_ms': stats_fwd,
        'plane_stats_backward_ms': stats_bwd,
        'statistics_share': (stats_fwd + stats_bwd) / device_ms,
        'conv_kernels_ms': conv, 'conv_share': conv / device_ms,
        'optimizer_ms': optim, 'optimizer_share': optim / device_ms,
        'top_ops_ms': top(by_op), 'top_kernels_ms': top(by_kernel)}),
        flush=True)
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
