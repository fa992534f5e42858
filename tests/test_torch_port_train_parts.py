"""The parts of the port's training held to the JAX package on the CPU:
the losses in every mode, the PatchGAN discriminators in train mode (batch
statistics, outputs and gradients), VGG19 features and the perceptual loss
from one weights npz, the five optimizers against optax on the same
gradients, each LR policy step by step, the plateau controller; the
statistics Function's gradient against autograd of the plain version in
double precision and the batch-coupled norm against JAX's
``batch_stat_norm(per_sample=False)``; dropout's rate, scale, train-only
rule and generator; the initializers' distributions. Tolerances: 1e-5
relative for float32 forwards and gradients of a few ops, 1e-6 for the
optimizers and schedules (elementwise arithmetic), 1e-10 in float64."""

import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu import nets as jnets
from deepliif_tpu import train_loop as jtrain
from deepliif_tpu.nets import discriminators as jd, layers as jL
from deepliif_tpu.nets import losses as jl, vgg as jv
from deepliif_tpu_torch import nets as tnets, train_loop as ttrain
from deepliif_tpu_torch.nets import layers as L, losses as tl, optim
from deepliif_tpu_torch.nets import vgg as tv
from deepliif_tpu_torch.utils import checkpoints as ck


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), scale)


# ---- losses

@pytest.mark.parametrize('mode', ['vanilla', 'lsgan', 'wgangp', 'poly_ce'])
@pytest.mark.parametrize('real', [True, False])
@pytest.mark.parametrize('smoothing', [0.0, 0.1])
def test_gan_loss_matches_jax(mode, real, smoothing):
    pred = np.random.default_rng(1).normal(0, 2, (2, 6, 6, 3)).astype(np.float32)
    want = jl.gan_loss(jnp.asarray(pred), real, mode, smoothing)
    got = tl.gan_loss(_nchw(pred), real, mode, smoothing)
    _close(got.item(), float(want), 1e-6)


def test_pixel_losses_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1.5, (2, 8, 8, 3)).astype(np.float32)
    b = rng.normal(0, 1.5, (2, 8, 8, 3)).astype(np.float32)
    for t_fn, j_fn in ((tl.smooth_l1, jl.smooth_l1), (tl.l1, jl.l1)):
        _close(t_fn(_nchw(a), _nchw(b)).item(),
               float(j_fn(jnp.asarray(a), jnp.asarray(b))), 1e-6)
    _close(tl.total_variation(_nchw(a)).item(),
           float(jl.total_variation(jnp.asarray(a))), 1e-6)
    s, t = rng.normal(0, 1, (2, 5, 4)), rng.normal(0, 1, (2, 5, 4))
    _close(tl.kl_div_softmax(torch.tensor(s, dtype=torch.float32),
                             torch.tensor(t, dtype=torch.float32), 2.0).item(),
           float(jl.kl_div_softmax(jnp.asarray(s, jnp.float32),
                                   jnp.asarray(t, jnp.float32), 2.0)), 1e-5)


@pytest.mark.parametrize('gp_type', ['real', 'fake', 'mixed'])
def test_gradient_penalty_matches_jax(gp_type):
    """'mixed' draws alpha from the port's generator; JAX's penalty of the
    same interpolation ('real' on it) is the reference."""
    torch.manual_seed(0)
    dnet = tnets.define_d(3, 8, 'n_layers', 2)
    L.init_net(dnet, generator=torch.Generator().manual_seed(3))
    params = ck.params_to_jax(dnet)
    rng = np.random.default_rng(4)
    real = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    got = tl.gradient_penalty(dnet, _nchw(real), _nchw(fake), gen, gp_type)
    if gp_type == 'mixed':
        alpha = torch.rand((2, 1, 1, 1), generator=torch.Generator()
                           .manual_seed(5)).numpy()
        real = alpha * real + (1 - alpha) * fake
    apply = lambda p, x: jd.nlayer_apply(p, x, n_layers=2)
    want = jl.gradient_penalty(apply, params, jnp.asarray(real),
                               jnp.asarray(fake), None,
                               'real' if gp_type == 'mixed' else gp_type)
    _close(got.item(), float(want), 1e-4)
    assert got.requires_grad            # differentiable (create_graph)


# ---- discriminators

@pytest.mark.parametrize('kind,n_layers,norm', [
    ('n_layers', 3, 'batch'), ('n_layers', 4, 'batch'),
    ('n_layers', 3, 'instance'), ('n_layers', 3, 'none'),
    ('basic', 3, 'batch'), ('pixel', 0, 'batch')])
def test_discriminator_train_mode_matches_jax(kind, n_layers, norm):
    """Output (batch statistics over the batch of 2) and the gradients of a
    weighted sum of it, w.r.t. every parameter and the input."""
    dnet = tnets.define_d(6, 8, kind, n_layers, norm)
    L.init_net(dnet, generator=torch.Generator().manual_seed(7))
    for p in dnet.parameters():         # biases away from 0
        p.data.add_(0.01 * torch.randn(p.shape, generator=torch.Generator()
                                       .manual_seed(8)))
    params = ck.params_to_jax(dnet)
    if kind == 'pixel':
        apply = lambda p, x: jd.pixel_apply(p, x, norm=norm)
    else:
        apply = lambda p, x: jd.nlayer_apply(
            p, x, n_layers=3 if kind == 'basic' else n_layers, norm=norm)
    x = np.random.default_rng(9).uniform(-1, 1, (2, 64, 64, 6)).astype(
        np.float32)
    want = np.asarray(apply(params, jnp.asarray(x)))
    xt = _nchw(x).requires_grad_(True)
    got = dnet(xt)
    _close(np.moveaxis(got.detach().numpy(), 1, -1), want, 1e-5)
    w = np.random.default_rng(10).normal(0, 1, want.shape).astype(np.float32)
    (got * _nchw(w)).sum().backward()
    gp, gx = jax.grad(lambda p, xx: (apply(p, xx) * w).sum(),
                      argnums=(0, 1))(params, jnp.asarray(x))
    _close(np.moveaxis(xt.grad.numpy(), 1, -1), gx, 1e-4)
    sds = {k: p.grad for k, p in dnet.named_parameters()}
    got_flat = ck.flatten_tree(ck.params_to_jax(dnet, sds))
    want_flat = ck.flatten_tree(jax.tree_util.tree_map(np.asarray, gp))
    assert sorted(got_flat) == sorted(want_flat)
    # a conv bias before an instance norm has gradient 0 (the norm takes
    # the mean out): each tensor is held against the largest gradient
    scale = max(np.abs(v).max() for v in want_flat.values())
    for k in want_flat:
        assert np.abs(got_flat[k] - want_flat[k]).max() <= 1e-4 * scale, k


def test_discriminator_layout_and_empty_patch_map():
    dnet = tnets.define_d(6, 8, 'n_layers', 4)
    assert [p for p, _, _ in dnet.jax_layout()][-1] == ('conv_out',)
    # conv0 w, b; conv1..4 w (no bias beside batch norm); norm1..4 scale,
    # bias; conv_out w, b
    assert len(ck.flatten_tree(ck.params_to_jax(dnet))) == 2 + 4 + 8 + 2
    with pytest.raises(ValueError, match='patch map is empty'):
        dnet(torch.zeros(2, 6, 16, 16))
    with pytest.raises(NotImplementedError):
        tnets.define_d(6, 8, 'spiral')


# ---- VGG19

@pytest.fixture(scope='module')
def vgg_npz(tmp_path_factory):
    """Random VGG19 weights in the JAX package's npz format."""
    rng = np.random.default_rng(11)
    data, i = {}, 0
    for sl in jv.SLICES:
        for item in sl:
            if item == 'pool':
                continue
            cin, cout = item
            data[f'conv{i}_w'] = rng.normal(
                0, (2 / (9 * cin)) ** 0.5, (3, 3, cin, cout)).astype(np.float32)
            data[f'conv{i}_b'] = rng.normal(0, 0.01, cout).astype(np.float32)
            i += 1
    path = tmp_path_factory.mktemp('vgg') / 'vgg19.npz'
    np.savez(path, **data)
    return str(path)


def test_vgg_features_and_loss_match_jax(vgg_npz, monkeypatch):
    net = tv.VGG19Features(vgg_npz)
    monkeypatch.setenv('DEEPLIIF_VGG19_WEIGHTS', vgg_npz)
    assert all(torch.equal(a, b) for a, b in zip(
        net.state_dict().values(), tv.VGG19Features().state_dict().values()))
    params = jv.init(weights_path=vgg_npz)
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    for got, want in zip(net.features(_nchw(x)),
                         jv.features(params, jnp.asarray(x))):
        _close(np.moveaxis(got.numpy(), 1, -1), want, 1e-5)
    xt = _nchw(x).requires_grad_(True)
    loss = tv.vgg_loss(net, xt, _nchw(y))
    loss.backward()
    want, gx = jax.value_and_grad(lambda a: jv.vgg_loss(
        params, a, jnp.asarray(y)))(jnp.asarray(x))
    _close(loss.item(), float(want), 1e-5)
    _close(np.moveaxis(xt.grad.numpy(), 1, -1), gx, 1e-4)
    # G losses at once: one pass of the G N images, a loss per group
    xs = np.stack([x, y[::-1]])
    ys = np.stack([y, x])
    grouped = tv.vgg_loss(net, torch.from_numpy(np.moveaxis(xs, -1, 2).copy()),
                          torch.from_numpy(np.moveaxis(ys, -1, 2).copy()))
    for g in range(2):
        _close(grouped[g].item(), float(jv.vgg_loss(
            params, jnp.asarray(xs[g]), jnp.asarray(ys[g]))), 1e-5)


def test_vgg_fallback_is_fixed_seed_kaiming(monkeypatch):
    monkeypatch.delenv('DEEPLIIF_VGG19_WEIGHTS', raising=False)
    a, b = tv.VGG19Features(), tv.VGG19Features()
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not any(p.requires_grad for p in a.parameters())
    for conv in a.convs:
        fan_in = conv.weight[0].numel()
        std = conv.weight.std().item()
        assert abs(std / (2 / fan_in) ** 0.5 - 1) < 0.05, (fan_in, std)
        assert not conv.bias.any()


# ---- optimizers and schedules

OPT = dict(lr_policy='linear', n_epochs=1, n_epochs_decay=3, epoch_count=1,
           beta1=0.5, lr_decay_iters=1)


@pytest.mark.parametrize('name', ['adam', 'adamw', 'sgd', 'rmsprop',
                                  'adagrad'])
@pytest.mark.parametrize('policy', ['linear', 'plateau'])
def test_optimizers_match_optax(name, policy):
    """Three updates on the same gradients: parameters within 1e-6 of max
    |p| of optax's (the linear schedule decays from the second update; the
    plateau policy's learning rate is rewritten between updates)."""
    opt = types.SimpleNamespace(**{**OPT, 'optimizer': name,
                                   'lr_policy': policy})
    rng = np.random.default_rng(13)
    shapes = {'w': (4, 3, 3, 3), 'b': (5,)}
    p0 = {k: rng.normal(0, 0.5, s).astype(np.float32)
          for k, s in shapes.items()}
    tx = jnets.make_optimizer(opt, 0.01, 1)
    jp, st = {k: jnp.asarray(v) for k, v in p0.items()}, None
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = optim.make_optimizer(opt, list(tp.values()), 0.01, 1)
    for step in range(3):
        g = {k: rng.normal(0, 1e-2 * (step + 1), s).astype(np.float32)
             for k, s in shapes.items()}
        if policy == 'plateau' and step == 2:
            st.hyperparams['learning_rate'] = jnp.asarray(0.004)
            for group in topt.param_groups:
                group['lr'] = 0.004
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in shapes:
            _close(tp[k].detach().numpy(), jp[k], 1e-6)
    assert topt.count == 3


def test_optimizer_defaults_are_optax_not_torch():
    assert (optim.ADAMW_DECAY, optim.RMS_DECAY, optim.RMS_EPS) == \
        (1e-4, 0.9, 1e-8)
    assert (optim.ADAGRAD_INIT, optim.ADAGRAD_EPS) == (0.1, 1e-7)
    with pytest.raises(NotImplementedError):
        optim.OptaxOptimizer([torch.nn.Parameter(torch.zeros(1))], 'lamb',
                             0.1)


@pytest.mark.parametrize('policy,extra', [
    ('linear', dict(n_epochs=3, n_epochs_decay=4, epoch_count=1)),
    ('linear', dict(n_epochs=2, n_epochs_decay=5, epoch_count=3)),
    ('step', dict(lr_decay_iters=2)),
    ('cosine', dict(n_epochs=5)),
    ('plateau', {})])
@pytest.mark.parametrize('steps_per_epoch', [1, 3])
def test_lr_policies_match_jax(policy, extra, steps_per_epoch):
    opt = types.SimpleNamespace(lr_policy=policy, **extra)
    want = jnets.make_lr_schedule(opt, steps_per_epoch)
    got = tnets.make_lr_schedule(opt, steps_per_epoch)
    for step in range(30):
        # multipliers in [0, 1]: JAX rounds them to float32 (cosine's cos
        # in float32 too)
        assert abs(got(step) - float(want(jnp.asarray(step)))) <= 1e-6
    with pytest.raises(NotImplementedError):
        tnets.make_lr_schedule(types.SimpleNamespace(lr_policy='wavy'))


def test_plateau_controller_matches_jax():
    metrics = [1.0, 0.995, 0.98, 0.97, 0.97, 0.97, 0.97, 0.97, 0.97, 0.97,
               0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.49, 0.3]
    a, b = ttrain.PlateauController(), jtrain.PlateauController()
    for m in metrics:
        assert a.step(m) == b.step(m)
        assert (a.mult, a.best, a.num_bad) == (b.mult, b.best, b.num_bad)
    assert a.mult < 1


# ---- the statistics Function and the train-mode norms

def test_statistics_gradient_against_autograd_of_plain_float64():
    x = torch.randn(3, 5, 7, 6, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(14)) + 0.7
    g = torch.randn(3, 2, 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(15))
    for xx in (x, x.contiguous(memory_format=torch.channels_last)):
        xa = xx.clone().requires_grad_(True)
        xb = xx.clone().requires_grad_(True)
        st = L.plane_mean_var_train(xa)
        ref = L.plane_mean_var_reference(xb)
        assert st.dtype == torch.float64
        _close(st.detach().numpy(), ref.detach().numpy(), 1e-12)
        da, = torch.autograd.grad(st, xa, g)
        db, = torch.autograd.grad(ref, xb, g)
        _close(da.numpy(), db.numpy(), 1e-10)
    assert torch.autograd.gradcheck(L.plane_mean_var_train,
                                    (x[:2, :3, :4, :5].clone()
                                     .requires_grad_(True),))


@pytest.mark.parametrize('norm', ['batch', 'instance'])
def test_train_norms_match_jax_with_gradients(norm):
    """train_batch_norm (statistics over (B, H, W) from the per-sample
    ones) against JAX batch_stat_norm(per_sample=False), instance norm
    under autograd against JAX instance_norm: outputs and the gradients of
    a weighted sum w.r.t. x, scale and bias."""
    rng = np.random.default_rng(16)
    x = rng.normal(0.4, 1.3, (3, 9, 10, 8)).astype(np.float32)
    scale = rng.normal(1, 0.1, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    if norm == 'batch':
        jfn = lambda a, s, b: jL.batch_stat_norm(a, {'scale': s, 'bias': b},
                                                 per_sample=False)
        layer = torch.nn.BatchNorm2d(8, track_running_stats=False)
        layer.weight.data[:] = torch.from_numpy(scale)
        layer.bias.data[:] = torch.from_numpy(bias)
    else:
        jfn = lambda a, s, b: jL.instance_norm(a)
        layer = None
    want, grads = jax.value_and_grad(lambda *a: (jfn(*a) * w).sum(),
                                     argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt = _nchw(x).requires_grad_(True)
    out = L.apply_norm(xt, norm, layer, train=True)
    got = (out * _nchw(w)).sum()
    got.backward()
    _close(got.item(), float(want), 1e-5)
    _close(np.moveaxis(xt.grad.numpy(), 1, -1), grads[0], 1e-5)
    if layer is not None:
        _close(layer.weight.grad.numpy(), grads[1], 1e-5)
        _close(layer.bias.grad.numpy(), grads[2], 1e-5)
        # the inference norm stays per sample
        per = L.apply_norm(_nchw(x), norm, layer)
        _close(np.moveaxis(per.detach().numpy(), 1, -1), jL.batch_stat_norm(
            jnp.asarray(x), {'scale': jnp.asarray(scale),
                             'bias': jnp.asarray(bias)}, per_sample=True),
            1e-5)


# ---- dropout and the initializers

def test_dropout_rate_scale_train_only_and_generator():
    x = torch.ones(4, 32, 64, 64).contiguous(memory_format=torch.channels_last)
    y = L.dropout(x, torch.Generator().manual_seed(1), 0.5, True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    assert torch.all(y[kept] == 2.0)
    assert y.is_contiguous(memory_format=torch.channels_last)
    again = L.dropout(x, torch.Generator().manual_seed(1), 0.5, True)
    other = L.dropout(x, torch.Generator().manual_seed(2), 0.5, True)
    assert torch.equal(y, again) and not torch.equal(y, other)
    for args in ((torch.Generator(), 0.5, False), (None, 0.5, False),
                 (torch.Generator(), 0.0, True)):
        assert L.dropout(x, *args) is x
    with pytest.raises(ValueError, match='Generator'):
        L.dropout(x, None, 0.5, True)


def test_dropout_runs_only_in_train_mode_of_the_nets():
    net = tnets.define_g(3, 3, 8, 'resnet_2blocks', use_dropout=True)
    L.init_net(net, generator=torch.Generator().manual_seed(3))
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    net.train()
    a = net(x, rng=torch.Generator().manual_seed(5))
    b = net(x, rng=torch.Generator().manual_seed(5))
    c = net(x, rng=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match='Generator'):
        net(x)                           # no generator: refused
    net.eval()
    assert torch.equal(net(x), net(x, rng=torch.Generator().manual_seed(5)))


@pytest.mark.parametrize('init_type', ['normal', 'xavier', 'kaiming',
                                       'orthogonal'])
def test_init_distributions(init_type):
    gain = 0.05
    net = tnets.define_g(3, 3, 16, 'resnet_2blocks', norm='batch')
    L.init_net(net, init_type, gain, torch.Generator().manual_seed(17))
    for path, prefix, kind in net.jax_layout():
        mod = net.get_submodule(prefix)
        if kind == 'norm':
            assert abs(mod.weight.mean().item() - 1) < 4 * gain / 8
            assert not mod.bias.any()
            continue
        hwio = ck.weight_to_hwio(mod.weight.detach(), kind)
        kh, kw, cin, cout = hwio.shape
        fan_in, fan_out = kh * kw * cin, kh * kw * cout
        if mod.bias is not None:
            assert not mod.bias.any()
        if hwio.numel() < 4000:
            continue
        std = hwio.std().item()
        if init_type == 'orthogonal':
            mat = hwio.reshape(-1, cout).double()
            gram = mat.T @ mat if mat.shape[0] >= cout else mat @ mat.T
            _close(gram.numpy(), gain ** 2 * np.eye(gram.shape[0]), 1e-5)
            continue
        want = {'normal': gain,
                'xavier': gain * (2 / (fan_in + fan_out)) ** 0.5,
                'kaiming': (2 / fan_in) ** 0.5}[init_type]
        assert abs(std / want - 1) < 0.05, (path, std, want)
    twin = tnets.define_g(3, 3, 16, 'resnet_2blocks', norm='batch')
    L.init_net(twin, init_type, gain, torch.Generator().manual_seed(17))
    assert all(torch.equal(p, q) for p, q in zip(net.parameters(),
                                                 twin.parameters()))
