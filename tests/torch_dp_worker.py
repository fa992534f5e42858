"""The data-parallel cases of tests/test_torch_port_data_parallel.py: each
runs in one process on the global batch, or in spawned gloo ranks on their
shards (``spawn_ranks``). Imports torch and the port alone (a spawned rank
loads this module and nothing of the JAX package)."""

import json
import os
import sys

import numpy as np
import torch

from deepliif_tpu_torch import parallel, train_loop
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.models import cyclegan as cg, deepliif as dl
from deepliif_tpu_torch.nets import vgg as vgg_t

# the JAX test's TINY DeepLIIF model (tests/test_parallel.py:16)
TINY = dict(modalities_no=2, net_g=('resnet_6blocks',) * 2,
            net_gs=('unet_32',) * 3, ngf=8, ndf=8, seg_weights=(0.4, 0.3, 0.3),
            loss_g_weights=(1 / 3,) * 3, loss_d_weights=(1 / 3,) * 3)
CYCLEGAN = dict(modalities_no=2, net_g=('resnet_2blocks',) * 2, ngf=8,
                ndf=8, loss_g_weights=(0.5, 0.5), loss_d_weights=(0.5, 0.5))
GLOBAL_BATCH, SIZE = 4, 64


def batch_arrays(seed, m=2, batch=GLOBAL_BATCH, size=SIZE):
    rng = np.random.default_rng(seed)
    shape = (batch, size, size, 3)
    return {'A': rng.uniform(-1, 1, shape).astype(np.float32),
            'B_mods': rng.uniform(-1, 1, (m,) + shape).astype(np.float32),
            'B_seg': rng.uniform(-1, 1, shape).astype(np.float32)}


def write_vgg(path, seed=9):
    """A VGG19 weights npz (the layout ``VGG19Features`` reads) of small
    random weights: cheaper to load than the default draw."""
    rng = np.random.default_rng(seed)
    out, i = {}, 0
    for sl in vgg_t.SLICES:
        for item in sl:
            if item == 'pool':
                continue
            cin, cout = item
            out[f'conv{i}_w'] = rng.normal(0, (2 / (9 * cin)) ** 0.5, (
                3, 3, cin, cout)).astype(np.float32)
            out[f'conv{i}_b'] = np.zeros(cout, np.float32)
            i += 1
    np.savez(path, **out)
    return path


def _record(state, metrics, params=True):
    rec = {"metrics": {k: v.numpy() for k, v in metrics.items()}}
    if params:
        rec['params'] = {n: p.detach().clone().numpy()
                         for n, p in state.nets.named_parameters()}
        rec['grads'] = {n: p.grad.detach().clone().numpy()
                        for n, p in state.nets.named_parameters()
                        if p.grad is not None}
    return rec


def run_case(name, vgg_path, rank=0, world=1):
    """Case ``name`` on this rank's shard of the global batch (all of it
    for a world of one): 'deepliif' (TINY, dropout on, one step),
    'deepliif_no_dropout' (one step), 'cyclegan' (two steps, pool size 2).
    Returns {'steps': [{'metrics', 'params', 'grads'}]}, the metrics the
    global means."""
    opt = Options(d_params=dict(TRAIN_DEFAULTS, pool_size=2))
    vnet = vgg_t.VGG19Features(vgg_path)
    rng = torch.Generator().manual_seed(1)
    if name == 'cyclegan':
        d = cg.CycleGANDef(**CYCLEGAN)
        state = cg.create_train_state(d, opt, 1, 0)
        step = train_loop.cyclegan_step(cg, d, vnet, opt, 0)
        seeds = (1, 2)
    else:
        d = dl.DeepLIIFDef(**TINY, use_dropout=name == 'deepliif')
        state = dl.create_train_state(d, opt, 1, 0)
        step = dl.make_train_step(d, vnet)
        seeds = (1,)
    dp = parallel.DataParallel(rank, world) if world > 1 else None
    steps = []
    with parallel.data_parallel(dp):
        for seed in seeds:
            batch = parallel.shard_batch(batch_arrays(seed), rank, world)
            batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
            state, metrics, _ = step(state, batch, rng)
            steps.append(_record(state, parallel.mean_over_ranks(metrics)))
    return {'steps': steps}


def _rank(rank, world, init_method, cases, vgg_path, out_dir):
    torch.set_num_threads(1)
    parallel.init_process_group('cpu', rank, world, init_method)
    try:
        res = {name: run_case(name, vgg_path, rank, world) for name in cases}
        torch.save(res, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def spawn_ranks(world, cases, vgg_path, out_dir, meanwhile=None):
    """Run ``cases`` in ``world`` spawned gloo ranks on the CPU, and
    ``meanwhile()`` in this process while they run; returns (each rank's
    results, what ``meanwhile`` returned)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank, args=(
        world, f'tcp://localhost:{parallel.free_port()}', cases, vgg_path,
        out_dir), nprocs=world, join=False, start_method='spawn')
    try:
        here = meanwhile() if meanwhile is not None else None
    finally:
        while not ctx.join(timeout=600):
            pass
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(world)], here


def record_modules(path):
    """A ``--remote-transfer-cmd`` that writes, beside the saved file, the
    jax and JAX-package modules loaded in this process."""
    loaded = sorted(m for m in sys.modules if m in ('jax', 'deepliif_tpu')
                    or m.startswith(('jax.', 'jaxlib', 'deepliif_tpu.')))
    with open(os.path.join(os.path.dirname(path), 'modules.json'), 'w') as f:
        json.dump(loaded, f)


def norm_case(device, seed=5, world=2, rows=2, c=16):
    """The inputs of the train-mode batch norm check: x (world x rows, c,
    9, 7) and the upstream gradient, on ``device``."""
    rng = np.random.default_rng(seed)
    shape = (world * rows, c, 9, 7)
    x = torch.from_numpy(rng.normal(0.3, 2.0, shape).astype(np.float32))
    up = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    scale = torch.from_numpy(rng.normal(1, 0.1, c).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32))
    return [t.to(device) for t in (x, up, scale, bias)]


def norm_grads(x, up, scale, bias, dp=None):
    """``layers.train_batch_norm`` of x (this rank's rows under ``dp``)
    and its gradients w.r.t. x, scale and bias for the loss sum(y up)
    (each rank's part of the global loss)."""
    from deepliif_tpu_torch.nets import layers as L
    x, scale, bias = (t.clone().requires_grad_(True) for t in (x, scale,
                                                               bias))
    with parallel.data_parallel(dp):
        y = L.train_batch_norm(x, scale, bias)
        grads = torch.autograd.grad((y * up).sum(), (x, scale, bias))
    return y.detach(), grads


def _norm_rank(rank, world, init_method, devices, out_dir):
    torch.set_num_threads(1)
    device = torch.device(devices[rank])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    parallel.init_process_group(device, rank, world, init_method, 'gloo')
    try:
        x, up, scale, bias = norm_case(device, world=world)
        k = x.shape[0] // world
        sl = slice(rank * k, (rank + 1) * k)
        y, (dx, dscale, dbias) = norm_grads(
            x[sl], up[sl], scale, bias, parallel.DataParallel(rank, world))
        # the parameters' gradients of the global loss: summed over ranks
        dscale, dbias = (parallel._ordered_sum(parallel._gather(g))
                         for g in (dscale, dbias))
        torch.save({k_: v.cpu() for k_, v in (('y', y), ('dx', dx),
                                               ('dscale', dscale),
                                               ('dbias', dbias))},
                   os.path.join(out_dir, f'norm{rank}.pt'))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def spawn_norm_ranks(devices, out_dir):
    """``_norm_rank`` in one spawned gloo rank per entry of ``devices``;
    returns each rank's y and gradients."""
    import torch.multiprocessing as mp
    mp.start_processes(_norm_rank, args=(
        len(devices), f'tcp://localhost:{parallel.free_port()}', devices,
        out_dir), nprocs=len(devices), join=True, start_method='spawn')
    return [torch.load(os.path.join(out_dir, f'norm{r}.pt'))
            for r in range(len(devices))]
