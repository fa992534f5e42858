"""Whether the device time of the flagship's seg nets (``unet_512``, cuDNN
bf16, the same calls on the bf16 and the int8 paths) moves with the path
that ran before them, with the card's clocks, or from one process to the
next, on one CUDA card.

    python3 experiments/torch_segnet_spread.py [--rounds 4]

Builds the bf16 and the int8 (scope ``resblocks``) sessions of the
flagship at random weights (``chip_smoke.write_flagship_model_dir``) and a
batch of 16 tiles as ``chip_smoke.py`` does. Then, in turns (bf16, int8,
int8, bf16, ...), each turn runs one ``run_tiles`` batch of its path and
times ``GS[0]`` by CUDA events as ``chip_smoke.py``'s ``per_net_ms`` does
(2 forwards after a warm-up) and over 20 forwards, and the host's time
to enqueue one forward (no synchronization inside it), with the card's SM
clock, power draw and throttle reasons read after it; one JSON line each.
Then, per path, one seg net and one ``run_tiles`` batch traced with
torch.profiler (CUDA activity): device time by kernel name (the top 12 and
the sum) and the caching allocator's device allocations during the batch.
Last, the card's name and power limit. Imports nothing of jax or
deepliif_tpu.

    python3 experiments/torch_segnet_spread.py --layout [--rounds 2]

Instead: whether the unet_512's innermost (S, 512, 1, 1) tensor should be
re-viewed as channels_last before its conv-transpose
(``layers.conv_transpose2d``; both layouts hold the same bytes, but the
strides decide whether cuDNN runs the whole up path in NHWC or NCHW). For
the float32 and the bfloat16 session in turn, ``GS[0]`` is timed by CUDA
events (5 forwards after a warm-up) as the port runs it and flipped
(float32 re-viewed, bfloat16 not), in turns port, flipped, flipped, port,
and one forward of each is traced by kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402

PATHS = ('bfloat16', 'int8')
CLOCKS = ('clocks.sm,clocks.mem,power.draw,temperature.gpu,'
          'clocks_throttle_reasons.active')


def card_state():
    for query in (CLOCKS, CLOCKS.rsplit(',', 1)[0]):
        res = subprocess.run(['nvidia-smi', f'--query-gpu={query}',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
        if res.returncode == 0:
            return dict(zip(query.split(','),
                            res.stdout.strip().splitlines()[0].split(', ')))
    return {'nvidia-smi': res.stderr.strip()}


def enqueue_ms(fn, iters=5):
    """Mean host time to launch ``fn``'s kernels, the card idle before."""
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def device_ms_by_kernel(fn, top=12):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        t = getattr(ev, 'device_time_total', None)
        if t is None:
            t = getattr(ev, 'cuda_time_total', 0.0)
        if t and str(getattr(ev, 'device_type', '')).endswith('CUDA'):
            per[ev.key] = (t / 1e3, ev.count)
    if not per:
        return {'kernels': 'no device time in the trace'}
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    return {'sum_ms': sum(v[0] for v in per.values()), 'n_names': len(per),
            'top': [{'name': k[:120], 'ms': v[0], 'count': v[1]}
                    for k, v in ranked[:top]]}


def alloc_stats():
    st = torch.cuda.memory_stats()
    return {k: st.get(k) for k in ('num_device_alloc', 'num_device_free',
                                   'num_alloc_retries')}


def flipped_conv_transpose2d(L, dtype):
    """``layers.conv_transpose2d`` with its 1x1 re-view flipped for
    ``dtype``: float32 re-viewed, bfloat16 not."""
    port = L.conv_transpose2d

    def conv_transpose2d(x, *args, **kwargs):
        if dtype == torch.float32:
            return port(L._channels_last_1x1(x), *args, **kwargs)
        keep, L._channels_last_1x1 = L._channels_last_1x1, lambda t: t
        try:
            return port(x, *args, **kwargs)
        finally:
            L._channels_last_1x1 = keep
    return conv_transpose2d


def layout_probe(M, L, md, batch, rounds):
    port = L.conv_transpose2d
    for p in ('float32', 'bfloat16'):
        s = M.init_nets(md, device='cuda', max_batch=smoke.BATCH,
                        precision=p, fuse_stages=False)
        x = (torch.from_numpy(batch).cuda().float() / 127.5
             - 1.0).permute(0, 3, 1, 2).to(s.d.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        seg = lambda: s.nets.GS[0](x)        # noqa: E731
        variants = {'port': port,
                    'flipped': flipped_conv_transpose2d(L, s.d.dtype)}
        with torch.no_grad():
            for turn in range(rounds):
                for v in ('port', 'flipped', 'flipped', 'port'):
                    L.conv_transpose2d = variants[v]
                    try:
                        ms = smoke.cuda_ms(seg, 5)
                    finally:
                        L.conv_transpose2d = port
                    print(json.dumps({'layout': p, 'variant': v,
                                      'round': turn,
                                      'seg_unet_512_ms_5': ms}), flush=True)
            for v in ('port', 'flipped'):
                L.conv_transpose2d = variants[v]
                try:
                    seg()
                    trace = device_ms_by_kernel(seg)
                finally:
                    L.conv_transpose2d = port
                print(json.dumps({'layout_trace': p, 'variant': v,
                                  'seg_unet_512': trace}), flush=True)
        del s, x
        M._init_nets_cached.cache_clear()
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--rounds', type=int, default=4)
    ap.add_argument('--layout', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the seg-net spread needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.ops import cuda_build, fused_resblock as FR

    M.configure_device(torch.device('cuda'))
    cuda_build.build({**FR._LIBS, **L._LIBS})
    big = smoke.ihc_like_image(2 * smoke.TILE, smoke.SEED)
    rng = np.random.default_rng(smoke.SEED + 1)
    origins = rng.integers(0, smoke.TILE + 1, (smoke.BATCH, 2))
    batch = np.stack([big[y:y + smoke.TILE, x:x + smoke.TILE]
                      for y, x in origins])
    with tempfile.TemporaryDirectory() as md:
        smoke.write_flagship_model_dir(md, dl)
        if args.layout:
            layout_probe(M, L, md, batch, args.rounds)
            print(smoke.nvidia_smi())
            return
        sessions, xs = {}, {}
        for p in PATHS:
            s = M.init_nets(md, device='cuda', max_batch=smoke.BATCH,
                            precision=p,
                            int8_scope='resblocks' if p == 'int8' else None,
                            fuse_stages=False)
            sessions[p] = s
            xs[p] = (torch.from_numpy(batch).cuda().float() / 127.5
                     - 1.0).permute(0, 3, 1, 2).to(s.d.dtype)
            s.run_tiles(batch)                  # warm-up
        order = []
        for _ in range(args.rounds):
            order += list(PATHS) + list(PATHS)[::-1]
        for turn, p in enumerate(order):
            s, x = sessions[p], xs[p]
            s.run_tiles(batch)
            with torch.no_grad():
                seg = lambda: s.nets.GS[0](x)   # noqa: E731
                ms2 = smoke.cuda_ms(seg, 2)
                ms20 = smoke.cuda_ms(seg, 20)
                host = enqueue_ms(seg)
            print(json.dumps({'turn': turn, 'path': p,
                              'dtype': str(s.d.dtype),
                              'seg_unet_512_ms_2': ms2,
                              'seg_unet_512_ms_20': ms20,
                              'host_enqueue_ms': host,
                              'card': card_state()}), flush=True)
        for p in PATHS:
            s, x = sessions[p], xs[p]
            with torch.no_grad():
                seg = device_ms_by_kernel(lambda: s.nets.GS[0](x))
            before = alloc_stats()
            whole = device_ms_by_kernel(lambda: s.run_tiles(batch), top=16)
            after = alloc_stats()
            print(json.dumps({
                'trace': p, 'seg_unet_512': seg, 'run_tiles_batch': whole,
                'allocator_during_batch': {
                    k: (after[k] - before[k]) if after[k] is not None
                    else None for k in after}}), flush=True)
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
