"""A full-width DeepLIIF training step at bfloat16 on one CUDA card with its
cuDNN convs run one sample at a time (``layers._per_sample``, inference's
rule, kept for its batch invariance) against the same convs run as one
call per conv (``layers.batched``, the training step's rule since this
measurement): 4 resnet_9blocks + 5 unet_512 + 9 n_layers-4
discriminators + VGG19 on the modalities, ngf = ndf = 64, 512^2, batch 2,
dropout on, random weights and batch from a seed.

    python3 experiments/torch_train_bf16_convs.py [--steps 4] [--batch 2]

Runs the two variants in turns (per sample, one call, one call, per
sample), each from the same fresh state: ``--steps`` steps timed by the
host clock around a synchronise (the first a warm-up, left out of the
median), with the peak memory; then two fresh one-step runs of each
variant, whose parameters must be bitwise equal for a variant to keep
training reproducible. Prints JSON lines, then the card's name and power
limit. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


@contextlib.contextmanager
def per_sample(L):
    """The training step's convs one sample at a time, as inference runs
    them (``layers.batched`` made a no-op)."""
    batched = L.batched
    L.batched = contextlib.nullcontext
    try:
        yield
    finally:
        L.batched = batched


def run(dl, vgg, d, opt, batch, steps):
    """``steps`` steps from the seeded state: (seconds per step, peak
    bytes, the parameters after the last step)."""
    dev = torch.device('cuda')
    state = dl.create_train_state(d, opt, 1, smoke.SEED, dev)
    step = dl.make_train_step(d, vgg.VGG19Features().to(dev))
    rng = torch.Generator(dev).manual_seed(smoke.SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(state, batch, rng)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    params = [p.detach().cpu() for p in state.g_params + state.d_params]
    peak = torch.cuda.max_memory_allocated()
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return seconds, peak, params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=4)
    ap.add_argument('--batch', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the bfloat16 step needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L, vgg
    from deepliif_tpu_torch.ops import cuda_build

    dev = torch.device('cuda')
    M.configure_device(dev)
    cuda_build.build(L._LIBS)
    d = dl.DeepLIIFDef(dtype=torch.bfloat16)
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    arrays = smoke.train_batch_arrays(smoke.TILE, args.batch,
                                      d.modalities_no, smoke.SEED)
    batch = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in arrays.items()}
    variants = {'per_sample': lambda: per_sample(L),
                'one_call': contextlib.nullcontext}
    timed = {k: [] for k in variants}
    for name in ('per_sample', 'one_call', 'one_call', 'per_sample'):
        with variants[name]():
            seconds, peak, _ = run(dl, vgg, d, opt, batch, args.steps)
        timed[name].append(dict(seconds=seconds,
                                median_s=float(np.median(seconds[1:])),
                                peak_gib=peak / 2 ** 30))
        print(json.dumps({'variant': name, **timed[name][-1]}), flush=True)
    for name, make in variants.items():
        with make():
            a = run(dl, vgg, d, opt, batch, 1)[2]
            b = run(dl, vgg, d, opt, batch, 1)[2]
        delta = max((x - y).abs().max().item() for x, y in zip(a, b))
        print(json.dumps({'variant': name, 'repro_max_abs_param_delta':
                          delta, 'bitwise_equal': delta == 0.0}), flush=True)
    print(json.dumps({'median_s': {k: [r['median_s'] for r in v]
                                   for k, v in timed.items()}}))
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())


if __name__ == '__main__':
    main()
