"""Training with spectral norm in the port against the JAX package on the
CPU, at float32 (the attention U-Net's train mode:
``test_torch_port_train_bf16.py``).

Spectral norm (the JAX ``add_spectral_u`` / ``_maybe_spectral`` /
``spectral_normalize_tree``): one and two DeepLIIF steps of the JAX test's
TINY model (2-block translators) with ``norm='spectral'`` (no norm
layers, no conv biases, a
power-iteration vector u beside every conv kernel of G, GS, D and DS)
against JAX's jitted step from the same weights and u (drawn by the port,
carried into JAX trees), at the limits of ``test_torch_port_train_step.py``:
every loss term within 1e-4 relative; D gradients at the same parameters
and G gradients against the same (JAX's updated) discriminators per
tensor within 1e-3 of the tensor's max |g|, the G ones plus twice the
port's own float32 distance from its float64 gradient (without norm
layers a float32 rounding flips a few ReLU branches, and JAX's float32
gradient lies as far from the float64 one as the port's; both agree to
1e-6 where no branch flips); JAX's gradient of every u is 0 and the port
keeps u out of its optimizer; the parameters after one step within 1e-6 on
99.9 % of the elements and within 2 lr. u after the step is the power
iteration from the stored u on the updated weights: the port's refresh of
JAX's updated weights gives JAX's u within 1e-5 relative
(``torch_train_helpers.check_refresh``), and after step 2 (from JAX's
state read through the JAX package's files, u and the optimizer's u
moments included) every u within 1e-3 relative (u follows the updated
weights, which agree within 2.12 lr). The other way, a run of the port's
``train --norm spectral`` is read by the JAX package's --continue-train
readers and stepped once in each package: the losses within 1e-4, the
parameters within 2.12 lr, every u within 1e-3, and the refresh of JAX's
weights JAX's u within 1e-5.
DeepLIIFKD with spectral norm, one step: the losses within 1e-4 relative
of JAX's, which keeps its quirks (the G loss runs the student on its raw
weights; no u refresh).

The behaviour of the other families under ``--norm spectral`` (the JAX
``def_from_opt`` of DeepLIIFExt, SDG and CycleGAN applies none): nets
without norm layers, conv biases or u, and a step equal to the
``--norm none`` step. Each JAX step is compiled once for the file."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu.models import deepliif as jdl, deepliif_ext as jext
from deepliif_tpu.models import deepliif_kd as jkd
from deepliif_tpu.utils import checkpoints as jck
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.models import (cyclegan, deepliif as dl,
                                       deepliif_ext as ext, deepliif_kd as kd,
                                       sdg)
from deepliif_tpu_torch.nets import vgg as vgg_t
from deepliif_tpu_torch.utils import checkpoints as ck

import torch_train_helpers as H

# the JAX test's TINY model with 2-block translators (a smaller JAX
# program to compile)
KW = dict(H.TINY, net_g=('resnet_2blocks',) * 2, use_dropout=False,
          norm='spectral')
# the port's u after a step from a shared state against JAX's (relative):
# u is the power iteration on the updated weights, which agree only within
# 2.12 lr (seen: 1.1e-5 alone, 1.8e-4 beside the suite's other workers);
# the refresh itself is held at 1e-5 on equal weights (check_refresh)
U_STEP_TOL = 1e-3


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def shapes(tree):
    """A tree of ``jax.ShapeDtypeStruct`` -> the flat layout of empty
    arrays of its shapes."""
    return H.flat(jax.tree_util.tree_map(
        lambda s: np.empty(s.shape, np.float32), tree))


@pytest.fixture(scope='module')
def spec(tmp_path_factory):
    # with JAX's G gradients of the same loss in float64 (under x64; JAX
    # keeps sigma and the loss reductions in float32)
    out = H.step_case(KW, str(tmp_path_factory.mktemp('jax_step1')),
                      f64=True)
    mods, up, arrays = out['vgg_upstream']
    out['port_grads_same_d_f64'] = H._g_grads_at(
        dl.DeepLIIFDef(**KW), vgg_t.VGG19Features(), out['jax'][0]['d'],
        arrays, up, torch.float64)
    return out


@pytest.mark.parametrize('step', [0, 1])
def test_spectral_losses_match_jax(spec, step):
    H.check_losses(spec, step)


def test_spectral_gradients_match_jax(spec):
    jd, jg = spec['jax_grads']
    assert H.only_u(jd) and H.only_u(jg)
    assert all(np.all(v == 0)
               for v in {**H.only_u(jd), **H.only_u(jg)}.values())
    got, want = spec['port_d_grads'], H.no_u(jd)
    assert sorted(got) == sorted(want)
    for k in want:
        assert H.rel(got[k], want[k]) <= 1e-3, k
    got, want = spec['port_grads_same_d'], H.no_u(jg)
    f64, jf64 = spec['port_grads_same_d_f64'], spec['jax_g_grads_f64']
    assert sorted(got) == sorted(want)
    for k in want:
        scale = np.abs(want[k]).max()
        own = np.abs(got[k] - f64[k]).max()
        jax_own = np.abs(want[k] - jf64[k]).max()
        assert np.abs(got[k] - want[k]).max() <= (1e-3 * scale + 2 * own
                                                   + 2 * jax_own), k


def test_spectral_parameters_after_one_step(spec):
    """As ``check_params_after_one_step``, over the parameters (u is held
    by ``test_spectral_u_refresh_matches_jax``)."""
    diffs, moved = [], []
    for i, part in enumerate(('g', 'd')):
        want, got = H.no_u(spec['jax'][0][part]), spec['port'][0][part]
        for k in want:
            diffs.append(np.abs(got[k] - want[k]).ravel())
            moved.append(np.abs(got[k] - spec['params0'][i][k]).max())
    diffs = np.concatenate(diffs)
    assert (diffs <= 1e-6).mean() >= 0.999, (diffs > 1e-6).mean()
    assert diffs.max() <= 2 * H.LR * (1 + 1e-3)
    assert min(moved) > 0


def check_u_after_step(out, step):
    """Every u of the port after a step from a shared state within
    U_STEP_TOL relative of JAX's (u follows the updated weights, which
    agree within 2.12 lr)."""
    for part in ('g', 'd'):
        want = H.only_u(out['jax'][step][part])
        got = out['port'][step][part]
        assert want
        for k in want:
            assert H.rel(got[k], want[k]) <= U_STEP_TOL, k


def test_spectral_u_refresh_matches_jax(spec):
    """Steps 1 and 2 (32 u vectors)."""
    initial = {**spec['params0'][0], **spec['params0'][1]}
    after = [{**spec['jax'][i]['g'], **spec['jax'][i]['d']} for i in (0, 1)]
    assert len(H.only_u(initial)) == 32
    H.check_refresh(initial, after[0], KW)
    H.check_refresh(after[0], after[1], KW)


def test_spectral_second_step_from_jax_files(spec):
    """Step 2 from JAX's state after step 1, read through the JAX
    package's files (u and the optimizer's u moments included)."""
    H.check_second_step(spec)
    check_u_after_step(spec, 1)


def test_u_of_every_group_as_jax_draws_it():
    """The port's u leaves have the keys and shapes of the JAX
    ``init_params`` tree with spectral norm (its ``add_spectral_u``), N(0,
    1) draws, and no norm parameters or conv biases beside them (the
    output convs keep theirs)."""
    d, jd = dl.DeepLIIFDef(**KW), jdl.DeepLIIFDef(**KW)
    want = shapes(jax.eval_shape(lambda: jdl.init_params(
        jax.random.PRNGKey(0), jd)))
    got = H.flat(H.jax_params(dl.init_nets(
        d, torch.Generator().manual_seed(0)), ('G', 'GS', 'D', 'DS')))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    us = np.concatenate([v.ravel() for v in H.only_u(got).values()])
    assert abs(us.mean()) < 0.05 and abs(us.std() - 1) < 0.05
    assert not any('norm' in k for k in got)


# TINY's weights of 1/3 on the command line (the float repr of 1/3)
THIRDS = ','.join([repr(1 / 3)] * 3)


def _spectral_rows(root):
    H.write_rows(os.path.join(root, 'train'), 4, count=2)


def test_port_spectral_run_steps_in_jax(spec, tmp_path):
    """A run of the port's ``train --norm spectral`` (TINY, one step) read
    by the JAX package's --continue-train readers (``load_networks``,
    ``load_pytree`` of ``latest_optim.npz``: u and its Adam moments
    included) and stepped once by JAX's step; the port steps once from the
    same files."""
    _spectral_rows(str(tmp_path / 'data'))
    run = H.port_train(tmp_path / 'data', tmp_path / 'ckpt', 'spec',
                       '--norm', 'spectral', '--modalities-no', '2',
                       '--no-dropout',
                       '--batch-size', '2', '--seg-weights', '0.4,0.3,0.3',
                       '--loss-weights-g', THIRDS, '--loss-weights-d', THIRDS)
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    state = dl.create_train_state(dl.DeepLIIFDef(**KW), opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    params = jck.load_networks(run, {**jstate.g_params, **jstate.d_params})
    before = H.flat(params)
    optim = jck.load_pytree(os.path.join(run, 'latest_optim.npz'), {
        'g': jstate.g_opt_state, 'd': jstate.d_opt_state,
        'step': jstate.step})
    assert int(optim['step']) == 1
    jstate = jdl.TrainState({k: params[k] for k in ('G', 'GS')},
                            {k: params[k] for k in ('D', 'DS')},
                            optim['g'], optim['d'], optim['step'])
    ck.load_networks(run, state.nets)
    ck.load_optim(os.path.join(run, 'latest_optim.npz'), state)
    assert H.flat(jstate.g_params).keys() == H.flat(H.jax_params(
        state.nets, ('G', 'GS'))).keys()
    arrays = H.batch_arrays(3, 2)
    jstate, jm, _ = spec['jstep'](jstate, H.jax_batch(arrays),
                                  jax.random.PRNGKey(2))
    state, metrics, _ = dl.make_train_step(
        dl.DeepLIIFDef(**KW), vgg_t.VGG19Features())(state,
                                                     H.torch_batch(arrays))
    out = {'jax': [], 'port': []}
    H.record(out, jstate, jm, state, metrics)
    out['shared_after_1'] = (True, 1, 1)
    out['jax'] = [None] + out['jax']
    out['port'] = [None] + out['port']
    H.check_losses(out, 1)
    H.check_second_step(out)
    check_u_after_step(out, 1)
    H.check_refresh(before, {**out['jax'][1]['g'], **out['jax'][1]['d']},
                    KW)


def test_kd_spectral_step_matches_jax():
    """One DeepLIIFKD step with spectral norm (TINY student, one
    modality; a batch-norm teacher of other weights): the losses within
    1e-4 relative of JAX's step, whose G loss runs the student on its raw
    weights; u unchanged in both packages (JAX's KD step refreshes
    none)."""
    import dataclasses
    kw = dict(KW, modalities_no=1, net_g=('resnet_6blocks',),
              net_gs=('unet_32',) * 2, seg_weights=(0.6, 0.4),
              loss_g_weights=(0.7, 0.3), loss_d_weights=(0.5, 0.5))
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    d, jd = dl.DeepLIIFDef(**kw), jdl.DeepLIIFDef(**kw)
    td = dataclasses.replace(d, norm='batch')
    tnets = dl.init_nets(td, torch.Generator().manual_seed(5),
                         with_discriminators=False).eval()
    tnets.requires_grad_(False)
    tp = H.jax_params(tnets, ('G', 'GS'))
    state = kd.create_train_state(d, opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    u0 = H.only_u({**H.flat(jstate.g_params), **H.flat(jstate.d_params)})
    vnet = vgg_t.VGG19Features()
    jstep = jkd.make_train_step(jd, g_tx, d_tx, H.vgg_jax(vnet), tp,
                                jdl.DeepLIIFDef(**dict(kw, norm='batch')))
    arrays = H.batch_arrays(1, 1)
    jstate, jm, _ = jstep(jstate, H.jax_batch(arrays), jax.random.PRNGKey(0))
    state, metrics, _ = kd.make_train_step(d, vnet, (tnets, td))(
        state, H.torch_batch(arrays))
    out = {'jax': [], 'port': []}
    H.record(out, jstate, jm, state, metrics)
    H.check_losses(out, 0)
    for part in ('g', 'd'):
        for k, v in H.only_u(out['port'][0][part]).items():
            assert np.array_equal(v, u0[k]), k
            assert np.array_equal(out['jax'][0][part][k], u0[k]), k


FAMILY_KW = {
    'ext': (ext, dict(modalities_no=1, net_g=('resnet_2blocks',),
                      net_gs=('unet_32',), ngf=8, ndf=8,
                      loss_g_weights=(1.0,), loss_d_weights=(1.0,),
                      use_dropout=False)),
    'sdg': (sdg, dict(modalities_no=1, net_g=('resnet_2blocks',), ngf=8,
                      ndf=8, loss_g_weights=(1.0,), loss_d_weights=(1.0,),
                      use_dropout=False)),
    'cyclegan': (cyclegan, dict(modalities_no=1, net_g=('resnet_2blocks',),
                                ngf=8, ndf=8, use_dropout=False))}


def family_step(name, norm):
    """One step of family ``name`` (FAMILY_KW) at ``norm``: (the nets'
    state dict, the step's metrics)."""
    from deepliif_tpu_torch import train_loop
    fam, kw = FAMILY_KW[name]
    d = getattr(fam, {'ext': 'DeepLIIFExtDef', 'sdg': 'SDGDef',
                      'cyclegan': 'CycleGANDef'}[name])(**kw, norm=norm)
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    state = fam.create_train_state(d, opt, 1, 0)
    rng = np.random.default_rng(4)
    shape = (2, 64, 64, 3)
    batch = {'A': rng.uniform(-1, 1, shape), 'B_mods': rng.uniform(
        -1, 1, (2 if name == 'sdg' else 1,) + shape)}
    if name == 'ext':
        batch['B_segs'] = rng.uniform(-1, 1, (1,) + shape)
    batch = {k: torch.tensor(v, dtype=torch.float32) for k, v in
             batch.items()}
    if name == 'cyclegan':
        step = train_loop.cyclegan_step(fam, d, vgg_t.VGG19Features(), opt, 0)
    else:
        step = fam.make_train_step(d, vgg_t.VGG19Features())
    state, metrics, _ = step(state, batch)
    return state.nets.state_dict(), metrics


@pytest.mark.parametrize('name', sorted(FAMILY_KW))
def test_other_families_spectral_is_no_norm(name):
    """DeepLIIFExt, SDG and CycleGAN under ``norm='spectral'`` build nets
    without norm layers, conv biases (the output convs keep theirs) or u,
    as the JAX families' nets (no norm parameters; the JAX trees of both
    norms have the same leaves), and train exactly as under 'none'."""
    sd, metrics = family_step(name, 'spectral')
    sd_none, metrics_none = family_step(name, 'none')
    assert not any(k.endswith('spectral_u') for k in sd)
    assert sd.keys() == sd_none.keys()
    assert all(torch.equal(sd[k], sd_none[k]) for k in sd)
    assert all(torch.equal(metrics[k], metrics_none[k]) for k in metrics)
    from deepliif_tpu.models import cyclegan as jcg, sdg as jsdg
    jmod, jdef = {'ext': (jext, 'DeepLIIFExtDef'), 'sdg': (jsdg, 'SDGDef'),
                  'cyclegan': (jcg, 'CycleGANDef')}[name]
    kw = FAMILY_KW[name][1]
    trees = [shapes(jax.eval_shape(lambda n=n: jmod.init_params(
        jax.random.PRNGKey(0), getattr(jmod, jdef)(**kw, norm=n))))
        for n in ('spectral', 'none')]
    assert trees[0].keys() == trees[1].keys()
    assert not any(k.endswith('/u') or 'norm' in k for k in trees[0])
