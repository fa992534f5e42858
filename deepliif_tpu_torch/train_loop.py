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
otherwise train the float32 convs in TF32. One loop for every family, as
in the JAX package: DeepLIIF, DeepLIIFKD, DeepLIIFExt and SDG run their
family's ``make_train_step`` (DeepLIIFKD with its frozen teacher, loaded
once from ``--model-dir-teacher``); CycleGAN's step (``cyclegan_step``)
runs its G step, queries the host image pools (seeded seed + i and seed
+ 100 + i) and runs its D step. --with-val computes every family's
validation losses, and the cell-count RMSE for DeepLIIF and DeepLIIFKD.
What this loop does not run raises NotImplementedError (ROADMAP.md,
"Training"): orbax checkpoints (and, in ``cli.train_device``, several
cards; ``trainlaunch`` in ``cli``).
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from . import roadmap
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
    fake A through pools_a[i], seed + i), the D step on the pooled fakes."""
    g_step, d_step = cg.make_train_steps(d, vgg_net)
    pool_size = getattr(opt, 'pool_size', 50)
    m = d.modalities_no
    pools_a = [cg.ImagePool(pool_size, seed + i) for i in range(m)]
    pools_b = [cg.ImagePool(pool_size, seed + 100 + i) for i in range(m)]

    def pooled(pools, fakes):
        return torch.stack([torch.from_numpy(np.asarray(pool.query(
            f.cpu().numpy()))) for pool, f in zip(pools, fakes)]).to(
                fakes.device)

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


def train_model(opt):
    """Run the whole training of ``opt.model``; returns (the final
    ``models.deepliif.TrainState``, the last step's metrics)."""
    check_trainable(opt)
    device = torch.device(getattr(opt, 'device', None) or 'cuda')
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

    dataset = create_dataset(opt, phase='train')
    batch = getattr(opt, 'batch_size', 1)
    steps_per_epoch = max(1, len(dataset) // max(1, batch))
    print(f'The number of training images = {len(dataset)}')

    save_options(opt)

    seed = getattr(opt, 'seed', None) or 0
    vgg_net = vgg.VGG19Features().to(device)
    teacher = (fam.load_teacher(teacher_dir, device)
               if model == 'DeepLIIFKD' else None)
    state = fam.create_train_state(d, opt, steps_per_epoch, seed, device)

    if getattr(opt, 'verbose', False):
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
        print(f'resumed networks from {save_dir} @ {epoch}')
        optim_path = os.path.join(save_dir, f'{epoch}_optim.npz')
        if os.path.exists(optim_path):
            checkpoints.load_optim(optim_path, state, plateau is not None)
            print(f'resumed optimizer state @ step {state.step}')
        if str(epoch).isdigit():
            epoch_base = int(epoch)

    step_fn = make_step(model, fam, d, vgg_net, opt, seed, teacher)
    # --with-val: every family's losses; the KD student's are DeepLIIF's
    eval_fam = dl if model in ('DeepLIIF', 'DeepLIIFKD') else fam
    eval_fn = (eval_fam.make_eval_losses(d, vgg_net)
               if getattr(opt, 'with_val', False) else None)
    visualizer = Visualizer(opt)
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
        _save_state(save_dir, state, suffix,
                    getattr(opt, 'remote_transfer_cmd', None),
                    plateau is not None)

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
                print(f'debug mode, epoch {epoch} stopped at epoch iter '
                      f'{epoch_iter}')
                break

        if epoch % save_epoch_freq == 0:
            save('latest')
            save(str(epoch + epoch_base))

        val_losses = None
        if eval_fn is not None:
            val_losses = _run_validation(opt, d, state, eval_fn, visualizer,
                                         epoch, rng, device)

        if plateau is not None:
            monitored = (float(np.mean(list(val_losses.values())))
                         if val_losses else
                         (epoch_g_sum / epoch_g_n if epoch_g_n else 0.0))
            if plateau.step(monitored):
                for optimizer, lr0 in ((state.g_opt, lr_g0),
                                       (state.d_opt, lr_d0)):
                    for group in optimizer.param_groups:
                        group['lr'] = lr0 * plateau.mult
                print(f'plateau: reducing learning rate (metric {monitored:.4f})')
            lr_now = lr_g0 * plateau.mult
        else:
            lr_now = lr_g0 * float(lr_sched(state.step))
        print(f'learning rate = {lr_now:.7f}')
        print(f'End of epoch {epoch} / {n_epochs + n_epochs_decay} \t '
              f'Time Taken: {time.time() - epoch_start:.0f} sec')

    save('latest')
    visualizer.plot_to_png()
    return state, metrics


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
