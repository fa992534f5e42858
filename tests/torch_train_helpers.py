"""Shared pieces of the port's training tests (tests/test_torch_port_train_*):
the JAX test's TINY model, seeded batches, and the bridge that carries the
port's weights, VGG and optimizer state into the JAX package's trees. No
JAX random draw is made: the first ``jax.random`` call of a process costs
about 13 s on this CPU."""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deepliif_tpu import nets as jnets
from deepliif_tpu.config import Options, TRAIN_DEFAULTS
from deepliif_tpu.models import deepliif as jdl
from deepliif_tpu.nets import vgg as jvgg
from deepliif_tpu.utils import checkpoints as jck
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.nets import vgg as vgg_t
from deepliif_tpu_torch.utils import checkpoints as ck

# the JAX package's tests/test_deepliif_model.py TINY, at batch 2
TINY = dict(modalities_no=2, net_g=('resnet_6blocks',) * 2,
            net_gs=('unet_32',) * 3, ngf=8, ndf=8, seg_weights=(0.4, 0.3, 0.3),
            loss_g_weights=(1 / 3,) * 3, loss_d_weights=(1 / 3,) * 3)
SIZE, BATCH = 64, 2


def batch_arrays(seed, m=2, size=SIZE, batch=BATCH):
    """A training batch in [-1, 1], float32 numpy NHWC."""
    rng = np.random.default_rng(seed)
    return {'A': rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32),
            'B_mods': rng.uniform(-1, 1, (m, batch, size, size, 3)
                                  ).astype(np.float32),
            'B_seg': rng.uniform(-1, 1, (batch, size, size, 3)
                                 ).astype(np.float32)}


def torch_batch(arrays):
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def jax_batch(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def jax_tree(group):
    """A group of the port's nets -> the JAX package's stacked param tree."""
    trees = [ck.params_to_jax(n) for n in group]
    return jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *trees)


def jax_params(nets_, names):
    return {k: jax_tree(g) for k, g in nets_.named_groups() if k in names}


def vgg_jax(net):
    """The port's VGG19Features -> the JAX package's VGG params."""
    out, i = [], 0
    for sl in vgg_t.SLICES:
        sp = []
        for item in sl:
            if item == 'pool':
                continue
            c = net.convs[i]
            i += 1
            sp.append({'w': jnp.asarray(c.weight.detach().permute(2, 3, 1, 0)
                                        .numpy()),
                       'b': jnp.asarray(c.bias.detach().numpy())})
        out.append(sp)
    return out


def flat(tree):
    return ck.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def grads_jax_layout(nets_, names):
    """The .grad of every parameter of the named groups, in the JAX
    package's flat stacked layout ('G/head_conv/w', ...)."""
    out = {}
    for name, group in nets_.named_groups():
        if name not in names:
            continue
        sds = [{k: p.grad for k, p in net.named_parameters()} for net in group]
        out.update({f'{name}/{k}': v for k, v in
                    ck.group_flat(group, sds).items()})
    return out


LR = 2e-4


def step_case(kw, ckpt_dir=None):
    """Step 1 of the model ``kw`` (DeepLIIFDef fields) in each package from
    the same state, with JAX's gradients of its losses (jitted): D at the
    initial parameters, G against JAX's updated discriminators, and the
    perceptual term's gradient w.r.t. JAX's generator outputs; with
    ``ckpt_dir``, JAX's state after step 1 (nets and optimizer) is then
    carried into the port through the JAX package's checkpoint files and
    step 2 runs in each package from that shared state: the optimizer is
    held apart from the gradients (after a free step 1 the two states
    differ by the sign flips of Adam's first update)."""
    torch.set_num_threads(2)
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    d, jd = dl.DeepLIIFDef(**kw), jdl.DeepLIIFDef(**kw)
    m = d.modalities_no
    state = dl.create_train_state(d, opt, 1, 0)
    vnet = vgg_t.VGG19Features()
    vp = vgg_jax(vnet)
    gp = jax_params(state.nets, ('G', 'GS'))
    dp = jax_params(state.nets, ('D', 'DS'))
    g_tx, d_tx = jnets.make_optimizer(opt, LR, 1), jnets.make_optimizer(
        opt, LR, 1)
    jstate = jdl.TrainState(gp, dp, g_tx.init(gp), d_tx.init(dp),
                            jnp.zeros((), jnp.int32))
    jstep = jdl.make_train_step(jd, g_tx, d_tx, vp)
    step = dl.make_train_step(d, vnet)
    out = {'kw': kw, 'params0': (flat(gp), flat(dp)), 'port': [], 'jax': []}

    def record(jstate, jm, state, metrics):
        out['jax'].append(dict(metrics={k: np.asarray(v) for k, v in
                                        jm.items()},
                               g=flat(jstate.g_params),
                               d=flat(jstate.d_params)))
        out['port'].append(dict(
            metrics={k: v.numpy() for k, v in metrics.items()},
            g=flat(jax_params(state.nets, ('G', 'GS'))),
            d=flat(jax_params(state.nets, ('D', 'DS')))))

    arrays = batch_arrays(1, m)
    jb = jax_batch(arrays)
    jstate, jm, _ = jstep(jstate, jb, jax.random.PRNGKey(0))
    state, metrics, _ = step(state, torch_batch(arrays))
    record(jstate, jm, state, metrics)
    out['port_d_grads'] = grads_jax_layout(state.nets, ('D', 'DS'))

    mods, seg = jax.jit(lambda g, a: jdl.generator_forward(
        g, a, jd, train=True, rng=jax.random.PRNGKey(0)))(gp, jb['A'])
    _, dgrads = jax.jit(jax.value_and_grad(jdl.d_loss_fn, has_aux=True),
                        static_argnums=3)(dp, {'mods': mods, 'seg': seg},
                                          jb, jd)
    _, ggrads = jax.jit(jax.value_and_grad(jdl.g_loss_fn, has_aux=True),
                        static_argnums=3)(gp, jstate.d_params, jb, jd, vp,
                                          jax.random.PRNGKey(0))
    w_feat = jd.lambda_feat * jnp.asarray(jd.loss_g_weights[:m])
    up = jax.jit(jax.grad(lambda x: (jax.vmap(
        lambda a, b: jvgg.vgg_loss(vp, a, b))(x, jb['B_mods'])
        * w_feat).sum()))(mods)
    out['jax_grads'] = (flat(dgrads), flat(ggrads))
    out['vgg_upstream'] = (np.asarray(mods), np.asarray(up), arrays)
    out['port_grads_same_d'] = _g_grads_at(
        d, vnet, out['jax'][0]['d'], arrays, np.asarray(up))
    if ckpt_dir is None:
        return out

    jck.save_networks(ckpt_dir, {**jstate.g_params, **jstate.d_params})
    jck.save_pytree(f'{ckpt_dir}/latest_optim.npz',
                    {'g': jstate.g_opt_state, 'd': jstate.d_opt_state,
                     'step': jstate.step})
    ck.load_networks(ckpt_dir, state.nets)
    ck.load_optim(f'{ckpt_dir}/latest_optim.npz', state)
    out['shared_after_1'] = (
        all(np.array_equal(a, out['jax'][0]['g'][k]) for k, a in
            flat(jax_params(state.nets, ('G', 'GS'))).items()),
        state.step, state.g_opt.count)
    arrays = batch_arrays(2, m)
    jstate, jm, _ = jstep(jstate, jax_batch(arrays), jax.random.PRNGKey(1))
    state, metrics, _ = step(state, torch_batch(arrays))
    record(jstate, jm, state, metrics)
    return out


def _g_grads_at(d, vnet, d_flat, arrays, vgg_up):
    """The port's G gradients of step 1's G loss against JAX's updated
    discriminators, with the perceptual term's gradient w.r.t. the
    generators' outputs ``vgg_up`` given (JAX's): the loss without the
    perceptual term plus <outputs, vgg_up>."""
    nets_ = dl.init_nets(d, torch.Generator().manual_seed(0)).train()
    # the generators of step 1: the initial draw, as in create_train_state
    for name, group in nets_.named_groups():
        if name in ('D', 'DS'):
            sub = {k[len(name) + 1:]: v for k, v in d_flat.items()
                   if k.startswith(name + '/')}
            for net, tree in zip(group, ck.group_trees(sub, len(group))):
                net.load_state_dict(ck.params_from_jax(net, tree))
    loss, (_, g_out) = dl.g_loss_fn(nets_, torch_batch(arrays),
                                    dataclasses.replace(d, lambda_feat=0.0),
                                    vnet)
    loss = loss + (g_out['mods'] * torch.from_numpy(vgg_up)).sum()
    params = [p for n, g in nets_.named_groups() if n in ('G', 'GS')
              for p in g.parameters()]
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    return grads_jax_layout(nets_, ('G', 'GS'))


def rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


def check_losses(out, step):
    """Every loss term within 1e-4 relative."""
    want = out['jax'][step]['metrics']
    got = out['port'][step]['metrics']
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])


def check_grads(out):
    """D gradients at the same parameters, G gradients against the same
    discriminators (the perceptual upstream gradient JAX's): per tensor
    within 1e-3 of its max |g|; the perceptual term's gradient w.r.t.
    JAX's generator outputs, in the port, within 1e-3 of its max, both
    packages in float64 (JAX under x64 for that call): the gradient is a
    step function of sign(a - b) and of the VGG ReLUs, and with the
    default VGG19 (JAX's own draw) float32 rounding flips deep feature
    positions at these inputs in either package (the port's float32 lies
    1 % of max from its float64, JAX's 0.55 %)."""
    check_grad_tensors(out)
    mods, _, arrays = out['vgg_upstream']
    d = dl.DeepLIIFDef(**out['kw'])
    x = torch.from_numpy(mods).double().requires_grad_(True)
    real = torch.from_numpy(arrays['B_mods']).double()
    w = d.lambda_feat * torch.tensor(d.loss_g_weights[:d.modalities_no],
                                     dtype=torch.float64)
    vnet = vgg_t.VGG19Features().double()
    (vgg_t.vgg_loss(vnet, x.movedim(-1, -3), real.movedim(-1, -3))
     * w).sum().backward()
    jax.config.update('jax_enable_x64', True)
    try:
        vp = vgg_jax(vnet)
        want = np.asarray(jax.grad(lambda a: (jax.vmap(
            lambda aa, bb: jvgg.vgg_loss(vp, aa, bb))(
                a, jnp.asarray(real.numpy())) * jnp.asarray(w.numpy())).sum())(
            jnp.asarray(x.detach().numpy())))
    finally:
        jax.config.update('jax_enable_x64', False)
    assert want.dtype == np.float64
    assert rel(x.grad.numpy(), want) <= 1e-3


def check_grad_tensors(out):
    """D gradients at the same parameters and G gradients against the same
    discriminators: every tensor within 1e-3 of its max |g|."""
    for got, want in ((out['port_d_grads'], out['jax_grads'][0]),
                      (out['port_grads_same_d'], out['jax_grads'][1])):
        assert sorted(got) == sorted(want)
        for k in want:
            assert rel(got[k], want[k]) <= 1e-3, k


def check_params_after_one_step(out):
    """Within 1e-6 on >= 99.9 % of all parameter elements, within 2 lr
    everywhere (Adam's first update is lr sign(g)); every tensor moved."""
    diffs, moved = [], []
    for part in ('g', 'd'):
        want, got = out['jax'][0][part], out['port'][0][part]
        p0 = out['params0'][part == 'd']
        for k in want:
            diffs.append(np.abs(got[k] - want[k]).ravel())
            moved.append(np.abs(got[k] - p0[k]).max())
    diffs = np.concatenate(diffs)
    assert (diffs <= 1e-6).mean() >= 0.999, (diffs > 1e-6).mean()
    assert diffs.max() <= 2 * LR * (1 + 1e-3)
    assert min(moved) > 0


# ---------------------------------------------------------------------------
# the other families (tests/test_torch_port_train_{ext,sdg,cyclegan,kd}.py)
# ---------------------------------------------------------------------------

def group_names(state, discriminators):
    return tuple(n for n, _ in state.groups(discriminators))


def jax_state(state, opt):
    """The JAX package's TrainState with the port's weights, and its
    optimizers (at LR, one step an epoch)."""
    gp = jax_params(state.nets, group_names(state, False))
    dp = jax_params(state.nets, group_names(state, True))
    g_tx, d_tx = jnets.make_optimizer(opt, LR, 1), jnets.make_optimizer(
        opt, LR, 1)
    return jdl.TrainState(gp, dp, g_tx.init(gp), d_tx.init(dp),
                          jnp.zeros((), jnp.int32)), g_tx, d_tx


def record(out, jstate, jm, state, metrics):
    """Append a step's metrics and parameters of each package to ``out``."""
    out['jax'].append(dict(metrics={k: np.asarray(v) for k, v in jm.items()},
                           g=flat(jstate.g_params), d=flat(jstate.d_params)))
    out['port'].append(dict(
        metrics={k: v.numpy() for k, v in metrics.items()},
        g=flat(jax_params(state.nets, group_names(state, False))),
        d=flat(jax_params(state.nets, group_names(state, True)))))


def jax_vgg_term(x, vp, real, w):
    """The JAX package's weighted perceptual terms, sum_i w_i
    vgg_loss(x_i, real_i) over the leading axis; every input an argument,
    so that a jit of it folds no constant VGG computation."""
    return (jax.vmap(lambda a, b: jvgg.vgg_loss(vp, a, b))(x, real)
            * w).sum()


def zero_vgg():
    """A VGG19Features of zero weights: its perceptual term is 0 with a
    zero gradient (|0 - 0|), so a loss built with it lacks that term."""
    net = vgg_t.VGG19Features()
    with torch.no_grad():
        for p in net.parameters():
            p.zero_()
    return net


def load_flat_groups(nets_, flat_params):
    """Load JAX-layout flat parameters ('D/conv0/w', ...) into the port's
    groups of those names."""
    for name, group in nets_.named_groups():
        sub = {k[len(name) + 1:]: v for k, v in flat_params.items()
               if k.startswith(name + '/')}
        if not sub:
            continue
        for net, tree in zip(group, ck.group_trees(sub, len(group))):
            net.load_state_dict(ck.params_from_jax(net, tree))


def port_g_grads(make_state, d_flat, loss_fn):
    """The port's G gradients of ``loss_fn(state)`` on a fresh state (the
    initial weights) whose discriminators hold ``d_flat`` (JAX's), in the
    JAX package's flat layout."""
    state = make_state()
    load_flat_groups(state.nets, d_flat)
    params = state.g_params
    for p, g in zip(params, torch.autograd.grad(loss_fn(state), params,
                                                allow_unused=True)):
        p.grad = torch.zeros_like(p) if g is None else g
    return grads_jax_layout(state.nets, group_names(state, False))


def share_jax_state(ckpt_dir, jstate, state):
    """Write JAX's state through the JAX package's checkpoint files and
    read it into the port's ``state``: (parameters equal, step, G count)."""
    jck.save_networks(ckpt_dir, {**jstate.g_params, **jstate.d_params})
    jck.save_pytree(f'{ckpt_dir}/latest_optim.npz',
                    {'g': jstate.g_opt_state, 'd': jstate.d_opt_state,
                     'step': jstate.step})
    ck.load_networks(ckpt_dir, state.nets)
    ck.load_optim(f'{ckpt_dir}/latest_optim.npz', state)
    want = flat(jstate.g_params)
    equal = all(np.array_equal(a, want[k]) for k, a in flat(jax_params(
        state.nets, group_names(state, False))).items())
    return equal, state.step, state.g_opt.count


def check_second_step(out):
    """Step 2 from JAX's state after step 1 (read through the JAX
    package's files): parameters within 2.12 lr (at update 2, with b1 0.5
    and b2 0.999, |mu^ / sqrt(nu^)| <= 1.055)."""
    equal, step, count = out['shared_after_1']
    assert equal and step == 1 and count == 1
    diffs = np.concatenate([np.abs(out['port'][1][part][k]
                                   - out['jax'][1][part][k]).ravel()
                            for part in ('g', 'd')
                            for k in out['jax'][1][part]])
    assert diffs.max() <= 2.12 * LR


_MASKS = {}


def _mask(nhwc):
    if nhwc not in _MASKS:
        seed = int(np.prod(nhwc)) % (2 ** 31)
        _MASKS[nhwc] = np.random.default_rng(seed).random(nhwc) < 0.5
    return _MASKS[nhwc]


@contextlib.contextmanager
def shared_dropout():
    """Both packages' ``layers.dropout`` replaced by one numpy mask per
    activation shape (keep p 0.5, kept values x 2): dropout masks cannot
    match across the packages' random generators. Yields {'jax': calls,
    'port': calls}."""
    from deepliif_tpu.nets import layers as jL
    from deepliif_tpu_torch.nets import layers as tL
    calls = {'jax': 0, 'port': 0}

    def jax_dropout(x, rng, rate=0.5, train=False):
        if not train or rng is None:
            return x
        calls['jax'] += 1
        return jnp.where(_mask(tuple(x.shape)), x / (1.0 - rate),
                         jnp.zeros_like(x))

    def port_dropout(x, rng, rate=0.5, train=False):
        if not train:
            return x
        calls['port'] += 1
        b, c, h, w = x.shape
        keep = torch.from_numpy(np.moveaxis(_mask((b, h, w, c)), -1, 1).copy())
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    mp = pytest.MonkeyPatch()
    mp.setattr(jL, 'dropout', jax_dropout)
    mp.setattr(tL, 'dropout', port_dropout)
    try:
        yield calls
    finally:
        mp.undo()


def write_rows(d, n_tiles, count=2, size=64, seed=0):
    """``count`` rows of ``n_tiles`` random tiles (PNG)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(count):
        row = rng.integers(0, 255, (size, size * n_tiles, 3), np.uint8)
        Image.fromarray(row).save(os.path.join(d, f'r{i}.png'))


CLI_ARGS = ['--net-g', 'resnet_2blocks', '--net-gs', 'unet_32', '--ngf',
            '8', '--ndf', '8', '--load-size', '64', '--crop-size', '64',
            '--scale-size', '64', '--seed', '0', '--device', 'cpu',
            '--n-epochs', '1', '--n-epochs-decay', '0', '--num-threads',
            '1']


def port_train(dataroot, ckpt, name, *extra):
    """The port's ``train`` through its CLI; returns the run's dir."""
    from deepliif_tpu_torch import cli
    cli.make_cli().main(['train', '--dataroot', str(dataroot),
                         '--checkpoints-dir', str(ckpt), '--name', name]
                        + CLI_ARGS + list(extra), standalone_mode=False)
    return os.path.join(str(ckpt), name)


def jax_resume_and_rewrite(run_dir, out_dir, state, opt):
    """What the JAX package's --continue-train reads of a run dir
    (deepliif_tpu/train_loop.py: ``load_networks`` of every group,
    ``load_pytree`` of ``latest_optim.npz`` into its optax states), into
    trees shaped as the port's ``state`` (a TrainState of the run's
    configuration), then written back by the JAX package's writers into
    ``out_dir``, with the run's config. Returns the trees read."""
    import shutil
    gp = jax_params(state.nets, group_names(state, False))
    dp = jax_params(state.nets, group_names(state, True))
    tx = jnets.make_optimizer(opt, LR, 1)
    nets_ = jck.load_networks(run_dir, {**gp, **dp})
    optim = jck.load_pytree(os.path.join(run_dir, 'latest_optim.npz'),
                            {'g': tx.init(gp), 'd': tx.init(dp),
                             'step': jnp.zeros((), jnp.int32)})
    os.makedirs(out_dir)
    for f in ('config.json', 'train_opt.txt'):
        shutil.copy(os.path.join(run_dir, f), out_dir)
    jck.save_networks(out_dir, nets_)
    jck.save_pytree(os.path.join(out_dir, 'latest_optim.npz'), optim)
    return nets_, optim


def serve_through_test(run_dir, out_dir, width=64, seed=1):
    """The port's ``test`` command (--device cpu, 64 px tiles) on one
    random image of 64 x ``width`` px with ``run_dir`` as the model dir;
    returns the names of the files it wrote."""
    from deepliif_tpu_torch import cli
    inp = os.path.join(str(out_dir), 'in')
    os.makedirs(inp)
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (64, width, 3), np.uint8)).save(os.path.join(inp, 'img.png'))
    out = os.path.join(str(out_dir), 'out')
    cli.make_cli().main(['test', '--input-dir', inp, '--output-dir', out,
                         '--tile-size', '64', '--model-dir', str(run_dir),
                         '--device', 'cpu'], standalone_mode=False)
    return sorted(os.listdir(out))


def optim_step(run_dir):
    with np.load(os.path.join(run_dir, 'latest_optim.npz')) as data:
        return int(data['step'])


def val_losses(run_dir):
    with open(os.path.join(run_dir, 'metrics_log.json')) as f:
        return json.load(f)['val'][-1]['losses']
