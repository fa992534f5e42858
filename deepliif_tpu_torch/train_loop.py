"""Training loop of every model family on one device, the port of
deepliif_tpu/train_loop.py: at float32 or bfloat16 (DeepLIIF and
DeepLIIFKD; the other families train in float32 at either, as in the JAX
package), with any norm, spectral included, and any generator, the
attention U-Net included.

Mirrors the reference epoch loop (reference cli.py:194-570) as the JAX
package does: per-iteration loss printing at print_freq, image grids at
display_freq (or for --monitor-image), latest / iter_N / epoch
checkpoints (nets and ``{suffix}_optim.npz`` in the JAX package's layout,
so a run resumes in either package), --continue-train / --load-iter,
--epoch-count, --debug, the linear, step, cosine and plateau LR policies
(``PlateauController``), --with-val (validation losses, and the cell-count
RMSE against val/metrics.json through the port's host quantifier) and
--remote-transfer-cmd.

The device is explicit (``opt.device``, default cuda): on a CUDA device
TF32 is turned off first (``models.configure_device``), since cuDNN would
otherwise train the float32 convs in TF32. In a ``torch.distributed``
process group (one process per card: ``cli``'s ``train`` on several
cards, ``trainlaunch`` under torchrun) the loop runs data parallel
(``data_parallel_plan``): each node's loader strides the indices by node
and yields ``batch_size`` samples a step, each rank loads its contiguous
slice, and the step runs inside ``parallel.data_parallel`` (global-batch
norm statistics and dropout masks, gradients averaged over ranks before
each update); the metrics are the global means. Printing, the visualizer,
--with-val and checkpoints run on each node's local rank 0. One loop for
every family, as in the JAX package: DeepLIIF, DeepLIIFKD, DeepLIIFExt and
SDG run their family's ``make_train_step`` (DeepLIIFKD with its frozen
teacher, loaded once from ``--model-dir-teacher``); CycleGAN's step
(``cyclegan_step``) runs its G step, queries the host image pools
(seeded seed + i and seed + 100 + i) and runs its D step. --with-val
computes every family's validation losses, and the cell-count RMSE for
DeepLIIF and DeepLIIFKD.
What this loop does not run raises NotImplementedError (ROADMAP.md,
"Training"): orbax checkpoints.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time

import numpy as np
import torch

from . import parallel, roadmap
from .config import save_options
from .data import create_dataset
from .models import configure_device, deepliif as dl, family_module
from .nets import make_lr_schedule, vgg
from .utils import checkpoints
from .utils.visualizer import Visualizer


def check_weights(model, modalities_no, seg_weights, loss_g_weights,
                  loss_d_weights):
    """(reference util/checks.py:3-17)"""
    expected = modalities_no + 1 if model in ('DeepLIIF', 'DeepLIIFKD') else modalities_no
    for name, w in (('seg_weights', seg_weights),
                    ('loss_G_weights', loss_g_weights),
                    ('loss_D_weights', loss_d_weights)):
        if len(w) != expected:
            raise ValueError(f'{name} needs {expected} entries, got {len(w)}')
        if abs(sum(w) - 1.0) >= 1e-6:
            raise ValueError(f'{name} must sum to 1 (got {sum(w)})')


class PlateauController:
    """ReduceLROnPlateau(mode='min', rel threshold) host-side controller
    (reference networks.py:74-75: factor=0.2, threshold=0.01, patience=5).

    The reference steps its scheduler with a metric that is never set (stays
    0, base_model.py:48,136); here the monitored metric is the mean epoch
    loss (or mean validation loss when --with-val is on), which is the
    documented intent of the policy.
    """

    def __init__(self, factor=0.2, threshold=0.01, patience=5):
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.best = None
        self.num_bad = 0
        self.mult = 1.0

    def step(self, metric):
        """Returns True if the LR multiplier was just reduced."""
        if self.best is None or metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
            return False
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.mult *= self.factor
            self.num_bad = 0
            return True
        return False


def check_trainable(opt):
    """Raise NotImplementedError ("Training") for what this loop does not
    run (orbax checkpoints), ValueError for a precision the JAX command
    does not train (its choices are float32 and bfloat16)."""
    precision = getattr(opt, 'precision', 'float32') or 'float32'
    if precision not in ('float32', 'bfloat16'):
        raise ValueError(f'training runs at float32 or bfloat16, got '
                         f'[{precision}]')
    if getattr(opt, 'checkpoint_format', 'npz') != 'npz':
        raise roadmap.not_ported(f'--checkpoint-format '
                                 f'{opt.checkpoint_format}', roadmap.TRAINING)


def batch_to_device(data, device):
    """Loader batch (numpy, NHWC) -> float32 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in data.items() if not k.endswith('_paths')}


def _cell_count_rmse(model_outputs, gt_metrics, tile_size, model):
    """RMSE of num_pos/num_neg/num_total/percent_pos vs metrics.json GT."""
    from . import postprocessing as pp
    from .utils import tensor2im
    from PIL import Image
    diffs = {k: [] for k in ('num_total', 'num_pos', 'num_neg', 'percent_pos')}
    for name, (input_img, seg_arr) in model_outputs.items():
        if name not in gt_metrics:
            continue
        seg_img = tensor2im(seg_arr)
        resolution = '40x' if tile_size > 384 else ('20x' if tile_size > 192 else '10x')
        try:
            _, _, scoring = pp.compute_final_results(
                Image.fromarray(tensor2im(input_img)), Image.fromarray(seg_img),
                None, resolution,
                seg_thresh=gt_metrics[name].get('prob_thresh',
                                                gt_metrics[name].get('seg_thresh', 150)))
        except Exception:
            continue
        for k in diffs:
            diffs[k].append((scoring[k] - gt_metrics[name][k]) ** 2)
    return {f'rmse_{k}': math.sqrt(np.mean(v)) if v else 0.0
            for k, v in diffs.items()}


def cyclegan_step(cg, d, vgg_net, opt, seed):
    """CycleGAN's step for the loop: step(state, batch, rng) -> (state,
    metrics, {'mods': fake_bs}): the G step, each modality's fakes through
    its host image pool (fake B through pools_b[i], seeded seed + 100 + i;
    fake A through pools_a[i], seed + i), the D step on the pooled fakes.
    Data parallel (one node), each rank gathers the fakes and queries its
    identical pools with the global batch's, then keeps its shard."""
    g_step, d_step = cg.make_train_steps(d, vgg_net)
    pool_size = getattr(opt, 'pool_size', 50)
    m = d.modalities_no
    pools_a = [cg.ImagePool(pool_size, seed + i) for i in range(m)]
    pools_b = [cg.ImagePool(pool_size, seed + 100 + i) for i in range(m)]

    def pooled(pools, fakes):
        # data parallel: every rank queries its identical pools with the
        # global batch's fakes (in rank order) and keeps its shard
        full = parallel.gather_detached(fakes, dim=1)
        out = torch.stack([torch.from_numpy(np.asarray(pool.query(
            f.cpu().numpy()))) for pool, f in zip(pools, full)]).to(
                fakes.device)
        dp, b = parallel.current(), fakes.shape[1]
        return out if dp is None else out.narrow(1, dp.rank * b, b)

    def step(state, batch, rng=None):
        real_as, real_bs = cg.real_pair(batch, d)
        state, gm, outs = g_step(state, real_as, real_bs, rng)
        state, dm = d_step(state, pooled(pools_b, outs['fake_bs']),
                           pooled(pools_a, outs['fake_as']), real_as,
                           real_bs)
        return state, {**gm, **dm}, {'mods': outs['fake_bs']}

    return step


def make_step(model, fam, d, vgg_net, opt, seed, teacher=None):
    """The loop's step(state, batch, rng) -> (state, metrics, g_out) of
    ``model``'s family."""
    if model == 'CycleGAN':
        return cyclegan_step(fam, d, vgg_net, opt, seed)
    return fam.make_train_step(d, vgg_net, **(
        {} if teacher is None else {'teacher': teacher}))


def _scalar(v):
    return float(v) if v.dim() == 0 else float(v.float().mean())


class _Silent:
    """The visualizer of a rank that does not report: every call does
    nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def data_parallel_plan(model, batch, local_world=None):
    """How this process trains: (``parallel.DataParallel`` or None, the
    loader's node and local-rank keywords (``data.create_dataset``),
    whether it steps at all). Outside a process group: alone. In one
    (``local_world`` ranks a node, default all): data parallel where the
    global batch (``batch`` a node) divides by the card count, as the JAX
    loop's ``use_mesh``; else, and for CycleGAN over several nodes (its
    host pools sit between its two steps), each node's local rank 0 steps
    alone on the node's batch, without gradient sync (the JAX loop's
    per-host stepping), and the others do nothing; a line says which."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None, {}, True
    rank, world = dist.get_rank(), dist.get_world_size()
    local_world = local_world or world
    dp = parallel.DataParallel(rank, world, rank % local_world, local_world)
    node = dict(rank=dp.node, world_size=dp.nodes)
    if model == 'CycleGAN' and dp.nodes > 1:
        why = ('CycleGAN queries its host image pools between its two steps '
               f'and runs data parallel on one node, not {dp.nodes}')
    elif batch % local_world:
        why = (f'the global batch ({batch * dp.nodes}) does not divide by '
               f'the card count ({world})')
    else:
        if rank == 0:
            print(f'data-parallel over {world} cards ({dp.nodes} node(s) of '
                  f'{local_world})')
        return dp, dict(node, local_rank=dp.local_rank,
                        local_world=local_world), True
    if dp.local_rank == 0:
        print(f'{why}: node {dp.node} trains on one card, without gradient '
              'sync')
    return None, node, dp.local_rank == 0


def train_model(opt, local_world=None):
    """Run the whole training of ``opt.model``; returns (the final
    ``models.deepliif.TrainState``, the last step's metrics (global means
    under data parallelism)). In a ``torch.distributed`` process group of
    one process per card (``local_world`` a node, default all) it trains
    as ``data_parallel_plan`` says; a process that does not step returns
    (None, {})."""
    check_trainable(opt)
    device = torch.device(getattr(opt, 'device', None) or 'cuda')
    if device.type == 'cuda' and device.index is None:
        # one card (the KD teacher's session too, which would take every
        # visible card for a bare 'cuda')
        device = torch.device('cuda', torch.cuda.current_device())
    configure_device(device)
    model = getattr(opt, 'model', 'DeepLIIF')
    fam = family_module(model)
    d = fam.def_from_opt(opt)
    m = d.modalities_no
    if model == 'DeepLIIFExt':
        check_weights(model, m, [1 / m] * m, list(d.loss_g_weights),
                      list(d.loss_d_weights))
    elif model not in ('CycleGAN', 'SDG'):
        check_weights(model, m, list(d.seg_weights), list(d.loss_g_weights),
                      list(d.loss_d_weights))
    teacher_dir = getattr(opt, 'model_dir_teacher', None)
    if model == 'DeepLIIFKD' and not teacher_dir:
        raise ValueError('DeepLIIFKD trains against a teacher: pass '
                         '--model-dir-teacher')

    batch = getattr(opt, 'batch_size', 1)
    dp, loader_kw, steps = data_parallel_plan(model, batch, local_world)
    if not steps:
        return None, {}
    main = dp is None or dp.local_rank == 0
    say = print if main else (lambda *args, **kwargs: None)
    dataset = create_dataset(opt, phase='train', **loader_kw)
    # the schedule advances by global steps: a node takes batch_size
    # samples of its stride a step
    steps_per_epoch = max(1, len(dataset) // max(
        1, batch * loader_kw.get('world_size', 1)))
    say(f'The number of training images = {len(dataset)}')

    if main:
        save_options(opt)

    seed = getattr(opt, 'seed', None) or 0
    vgg_net = vgg.VGG19Features().to(device)
    teacher = (fam.load_teacher(teacher_dir, device)
               if model == 'DeepLIIFKD' else None)
    state = fam.create_train_state(d, opt, steps_per_epoch, seed, device)

    if getattr(opt, 'verbose', False) and main:
        for name, group in state.nets.named_groups():
            n = sum(p.numel() for p in group.parameters())
            print(f'[network {name}] parameters: {n / 1e6:.3f} M')

    lr_policy = getattr(opt, 'lr_policy', 'linear')
    plateau = PlateauController() if lr_policy == 'plateau' else None
    save_dir = os.path.join(opt.checkpoints_dir, opt.name)
    epoch_base = 0
    if getattr(opt, 'continue_train', False):
        epoch = getattr(opt, 'epoch', 'latest')
        try:
            checkpoints.load_networks(save_dir, state.nets, epoch)
        except FileNotFoundError as e:
            raise FileNotFoundError(f'--continue-train set but checkpoint '
                                    f'missing: {e}')
        say(f'resumed networks from {save_dir} @ {epoch}')
        optim_path = os.path.join(save_dir, f'{epoch}_optim.npz')
        if os.path.exists(optim_path):
            checkpoints.load_optim(optim_path, state, plateau is not None)
            say(f'resumed optimizer state @ step {state.step}')
        if str(epoch).isdigit():
            epoch_base = int(epoch)

    step_fn = make_step(model, fam, d, vgg_net, opt, seed, teacher)
    # --with-val: every family's losses; the KD student's are DeepLIIF's
    eval_fam = dl if model in ('DeepLIIF', 'DeepLIIFKD') else fam
    eval_fn = (eval_fam.make_eval_losses(d, vgg_net)
               if getattr(opt, 'with_val', False) else None)
    visualizer = Visualizer(opt) if main else _Silent()
    rng = torch.Generator(device).manual_seed(seed + 1)

    total_iters = 0
    print_freq = getattr(opt, 'print_freq', 100)
    display_freq = getattr(opt, 'display_freq', 400)
    save_latest_freq = getattr(opt, 'save_latest_freq', 500)
    save_epoch_freq = getattr(opt, 'save_epoch_freq', 100)
    n_epochs = getattr(opt, 'n_epochs', 100)
    n_epochs_decay = getattr(opt, 'n_epochs_decay', 100)
    epoch_count = getattr(opt, 'epoch_count', 1)
    save_by_iter = getattr(opt, 'save_by_iter', False)
    lr_g0 = getattr(opt, 'lr_g', 2e-4)
    lr_d0 = getattr(opt, 'lr_d', 2e-4)
    lr_sched = make_lr_schedule(opt, steps_per_epoch)

    def save(suffix):
        if not main:
            return
        _save_state(save_dir, state, suffix,
                    getattr(opt, 'remote_transfer_cmd', None),
                    plateau is not None)

    with parallel.data_parallel(dp):
        metrics = {}
        # plateau without validation monitors the mean train loss_G of the
        # epoch, a per-step read of the device: only under that policy
        track_epoch_loss = plateau is not None and eval_fn is None
        for epoch in range(epoch_count, n_epochs + n_epochs_decay + 1):
            epoch_start = time.time()
            iter_data_time = time.time()
            epoch_iter = 0
            epoch_g_sum, epoch_g_n = 0.0, 0
            visualizer.reset()
            dataset.set_epoch(epoch)

            for data in dataset:
                iter_start = time.time()
                t_data = iter_start - iter_data_time
                total_iters += batch
                epoch_iter += batch

                state, metrics, g_out = step_fn(
                    state, batch_to_device(data, device), rng)
                metrics = parallel.mean_over_ranks(metrics)
                if track_epoch_loss:
                    epoch_g_sum += _scalar(metrics['loss_G'])
                    epoch_g_n += 1

                if total_iters % print_freq == 0:
                    m = {k: _scalar(v) for k, v in metrics.items()}
                    t_comp = (time.time() - iter_start) / batch
                    visualizer.print_current_losses(epoch, epoch_iter, m, t_comp, t_data)
                    visualizer.plot_current_losses(
                        epoch, epoch_iter / max(1, len(dataset)), m)

                monitor = getattr(opt, 'monitor_image', None)
                display_now = (total_iters % display_freq == 0 if monitor is None
                               else data['A_paths'][0].endswith(monitor))
                if display_now:
                    vis = {'real_A': np.asarray(data['A'][0][..., :3])}
                    mods = g_out['mods'].cpu().numpy()
                    for i in range(mods.shape[0]):
                        vis[f'fake_B_{i+1}'] = mods[i][0]
                    if 'seg' in g_out:
                        vis['fake_B_S'] = g_out['seg'].cpu().numpy()[0]
                    if 'segs' in g_out:
                        segs = g_out['segs'].cpu().numpy()
                        for i in range(segs.shape[0]):
                            vis[f'fake_BS_{i+1}'] = segs[i][0]
                    visualizer.display_current_results(vis, epoch, True)

                if total_iters % save_latest_freq == 0:
                    # --save-by-iter keeps every snapshot under iter_<N> instead
                    # of overwriting latest (reference cli.py:472-475)
                    save(f'iter_{total_iters}' if save_by_iter else 'latest')
                iter_data_time = time.time()

                if (getattr(opt, 'debug', False)
                        and epoch_iter >= getattr(opt, 'debug_data_size', 10)):
                    # reference cli.py:479-481: debug mode caps each epoch
                    say(f'debug mode, epoch {epoch} stopped at epoch iter '
                        f'{epoch_iter}')
                    break

            if epoch % save_epoch_freq == 0:
                save('latest')
                save(str(epoch + epoch_base))

            val_losses = None
            if eval_fn is not None and main:
                with parallel.data_parallel(None):   # this rank alone
                    val_losses = _run_validation(opt, d, state, eval_fn,
                                                 visualizer, epoch, rng,
                                                 device)
            if eval_fn is not None and dp is not None:
                # validation drew dropout masks on rank 0 alone: every rank
                # goes on from its generator state, as one device would
                rng.set_state(parallel.broadcast(rng.get_state()))

            if plateau is not None:
                monitored = (float(np.mean(list(val_losses.values())))
                             if val_losses else
                             (epoch_g_sum / epoch_g_n if epoch_g_n else 0.0))
                # every rank takes rank 0's decision (its validation)
                monitored = parallel.broadcast(monitored)
                if plateau.step(monitored):
                    for optimizer, lr0 in ((state.g_opt, lr_g0),
                                           (state.d_opt, lr_d0)):
                        for group in optimizer.param_groups:
                            group['lr'] = lr0 * plateau.mult
                    say(f'plateau: reducing learning rate (metric {monitored:.4f})')
                lr_now = lr_g0 * plateau.mult
            else:
                lr_now = lr_g0 * float(lr_sched(state.step))
            say(f'learning rate = {lr_now:.7f}')
            say(f'End of epoch {epoch} / {n_epochs + n_epochs_decay} \t '
                  f'Time Taken: {time.time() - epoch_start:.0f} sec')

        save('latest')
        visualizer.plot_to_png()
    return state, metrics


def train_on_devices(opt, devices, echo=print):
    """``train`` on ``devices`` of this host (the JAX command's
    ``jax.devices()``): one device, or a global batch (``batch_size``)
    that does not divide by the card count, trains in this process on the
    first (a line says why); else one spawned process per device, joined
    in a process group (NCCL on distinct cards, gloo on the CPU or with a
    card twice), each running ``train_model`` data parallel. Returns this
    process's (state, metrics), or (None, {}) after the spawned ranks
    ended; a rank's failure raises here."""
    batch = getattr(opt, 'batch_size', 1)
    if len(devices) > 1 and batch % len(devices):
        echo(f'the global batch ({batch}) does not divide by the card count '
             f'({len(devices)}): training on {devices[0]} alone')
    if len(devices) == 1 or batch % len(devices):
        opt = copy.copy(opt)
        opt.device = str(devices[0])
        return train_model(opt)
    import torch.multiprocessing as mp
    cuda = all(torch.device(d).type == 'cuda' for d in devices)
    backend = 'nccl' if cuda and len(set(map(str, devices))) == len(
        devices) else 'gloo'
    echo(f'spawning {len(devices)} ranks ({backend}) on '
         f'{", ".join(map(str, devices))}')
    mp.start_processes(_spawned_rank, args=(
        [str(d) for d in devices], f'tcp://localhost:{parallel.free_port()}',
        backend, opt), nprocs=len(devices), join=True,
        start_method='spawn')
    return None, {}


def _spawned_rank(rank, devices, init_method, backend, opt):
    """A rank of ``train_on_devices``: devices[rank] in a process group of
    len(devices)."""
    train_in_group(opt, devices[rank], rank=rank, world=len(devices),
                   init_method=init_method, backend=backend)


def train_in_group(opt, device, local_world=None, **group):
    """``train_model`` on ``device`` in a process group that this process
    joins first (``parallel.init_process_group``'s ``group`` keywords; by
    default from the torchrun environment) and leaves at the end;
    ``local_world`` ranks a node (default all)."""
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    parallel.init_process_group(device, **group)
    try:
        opt = copy.copy(opt)
        opt.device = str(device)
        return train_model(opt, local_world)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def _save_state(save_dir, state, suffix, remote_transfer_cmd=None,
                plateau=False):
    checkpoints.save_networks(save_dir, state.nets, suffix)
    optim_path = os.path.join(save_dir, f'{suffix}_optim.npz')
    checkpoints.save_optim(optim_path, state, plateau)
    if remote_transfer_cmd:
        _remote_transfer(remote_transfer_cmd, save_dir, suffix, optim_path)


def _remote_transfer(cmd, save_dir, suffix, optim_path):
    """Invoke a user-supplied 'module.function(path)' on each saved file
    (reference --remote-transfer-cmd, base_model.py:49-56)."""
    import importlib
    try:
        mod_name, fn_name = cmd.rsplit('.', 1)
        fn = getattr(importlib.import_module(mod_name), fn_name)
    except Exception as e:
        print(f'remote-transfer-cmd {cmd!r} not loadable: {e}')
        return
    for f in sorted(os.listdir(save_dir)):
        if f.startswith(f'{suffix}_net_') or f == os.path.basename(optim_path):
            try:
                fn(os.path.join(save_dir, f))
            except Exception as e:
                print(f'remote transfer failed for {f}: {e}')


def _run_validation(opt, d, state, eval_fn, visualizer, epoch, rng, device):
    """Returns the mean validation losses dict (or None if no val set)."""
    try:
        dataset_val = create_dataset(opt, phase='val')
    except FileNotFoundError:
        print('with_val set but no val directory found; skipping validation')
        return None
    losses_acc = []
    outputs = {}
    gt_path = os.path.join(opt.dataroot, 'val', 'metrics.json')
    # seg outputs feed only the cell-count RMSE vs metrics.json, so the
    # inference forward runs only where that ground truth exists, and for
    # the families with a seg and counts (DeepLIIF, DeepLIIFKD)
    want_outputs = (os.path.exists(gt_path)
                    and getattr(opt, 'model', 'DeepLIIF')
                    in ('DeepLIIF', 'DeepLIIFKD'))
    for data in dataset_val:
        batch = batch_to_device(data, device)
        m = eval_fn(state, batch, rng)
        losses_acc.append({k: _scalar(v) for k, v in m.items()})
        if want_outputs:
            name = os.path.splitext(os.path.basename(data['A_paths'][0]))[0]
            state.nets.eval()
            try:
                with torch.no_grad():
                    _, seg = dl.generator_forward(state.nets, batch['A'], d)
            finally:
                state.nets.train()
            outputs[name] = (data['A'][0], seg[0].float().cpu().numpy())
    avg = None
    if losses_acc:
        avg = {k: float(np.mean([x[k] for x in losses_acc]))
               for k in losses_acc[0]}
        visualizer.plot_current_losses_val(epoch, avg)
    if os.path.exists(gt_path) and outputs:
        with open(gt_path) as f:
            gt = json.load(f)
        rmse = _cell_count_rmse(outputs, gt, getattr(opt, 'crop_size', 512),
                                opt.model)
        visualizer.plot_current_metrics(epoch, rmse)
        print('val cell-count RMSE:', rmse)
    return avg
