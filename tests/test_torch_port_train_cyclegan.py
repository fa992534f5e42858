"""CycleGAN training in the port against the JAX package on the CPU.

Two iterations of the JAX test's TINY CycleGAN model (modalities 1,
resnet_6blocks, ngf = ndf = 8, 64^2, batch 2, lsgan, label smoothing
0.1, image pools of 1 so that the second iteration swaps) through the
port's loop step (``train_loop.cyclegan_step``: the G step, the host
pools seeded seed + i and seed + 100 + i, the D step) against the JAX
package's two jitted steps with its own ``ImagePool``s between them,
from the same weights and VGG. At the limits of
``test_torch_port_train_step.py``: every loss term of both steps within
1e-4 relative; G gradients (against the initial discriminators, as G
updates first) and D gradients (on each package's pooled fakes) per
tensor within 1e-3 of the tensor's max |g|, the G gradients with the
perceptual term's gradient w.r.t. the fakes taken from JAX (the port's G
loss with a zero VGG plus <fakes, JAX's upstream gradient>); the
parameters after one iteration; the second iteration from JAX's state
read through the JAX package's files. Without dropout, and with one
dropout mask per activation shape injected into both packages.

``ImagePool`` is bit-equal to JAX's over runs of queries at pool sizes
0, 1 and 50. The quirks of the JAX package: G updates before D, D sees
the pooled fakes, label smoothing scales the G side's target too, the
step counts in the D step only. Then the unaligned and single datasets
against JAX's, and the CLI: one epoch with --with-val, the checkpoint
crossing to the JAX package's --continue-train readers and back, and the
checkpoint run through the port's ``test`` command."""

import os
import random
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deepliif_tpu.config import Options as JOptions
from deepliif_tpu.config import TRAIN_DEFAULTS as J_DEFAULTS
from deepliif_tpu.data import create_dataset as j_create_dataset
from deepliif_tpu.models import cyclegan as jcg
from deepliif_tpu_torch import train_loop
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.data import create_dataset
from deepliif_tpu_torch.models import cyclegan as cg
from deepliif_tpu_torch.nets import losses
from deepliif_tpu_torch.nets import vgg as vgg_t

import torch_train_helpers as H

KW = dict(modalities_no=1, net_g=('resnet_6blocks',), ngf=8, ndf=8,
          gan_mode='lsgan', label_smoothing=0.1, loss_g_weights=(1.0,),
          loss_d_weights=(1.0,))
POOL, SEED = 1, 0


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def arrays(seed):
    rng = np.random.default_rng(seed)
    shape = (H.BATCH, H.SIZE, H.SIZE, 3)
    return {'A': rng.uniform(-1, 1, shape).astype(np.float32),
            'B_mods': rng.uniform(-1, 1, (1,) + shape).astype(np.float32)}


def step_case(kw, ckpt_dir=None):
    opt = Options(d_params=dict(TRAIN_DEFAULTS, pool_size=POOL))
    d, jd = cg.CycleGANDef(**kw), jcg.CycleGANDef(**kw)
    state = cg.create_train_state(d, opt, 1, SEED)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    gp, dp = jstate.g_params, jstate.d_params
    vnet = vgg_t.VGG19Features()
    vp = H.vgg_jax(vnet)
    out = {'kw': kw, 'params0': (H.flat(gp), H.flat(dp)), 'port': [],
           'jax': [], 'pooled': []}
    g_step, d_step = jcg.make_train_steps(jd, g_tx, d_tx, vp)
    pools_a = [jcg.ImagePool(POOL, SEED)]
    pools_b = [jcg.ImagePool(POOL, SEED + 100)]

    def jax_iteration(jstate, a, key):
        real_as = jnp.asarray(a['A'])[None]
        real_bs = jnp.asarray(a['B_mods'])
        jstate, gm, outs = g_step(jstate, real_as, real_bs, key)
        fb = jnp.stack([jnp.asarray(pools_b[0].query(
            np.asarray(outs['fake_bs'][0])))])
        fa = jnp.stack([jnp.asarray(pools_a[0].query(
            np.asarray(outs['fake_as'][0])))])
        jstate, dm = d_step(jstate, fb, fa, real_as, real_bs)
        return jstate, {**gm, **dm}, outs, (fb, fa)

    step = train_loop.cyclegan_step(cg, d, vnet, opt, SEED)
    a = arrays(1)
    jstate, jm, jouts, (jfb, jfa) = jax_iteration(jstate, a,
                                                  jax.random.PRNGKey(0))
    state, metrics, _ = step(state, H.torch_batch(a))
    H.record(out, jstate, jm, state, metrics)
    out['port_d_grads'] = H.grads_jax_layout(state.nets, ('DA', 'DB'))

    real_as = jnp.asarray(a['A'])[None]
    real_bs = jnp.asarray(a['B_mods'])
    _, dgrads = jax.jit(jax.value_and_grad(jcg.d_loss_fn, has_aux=True),
                        static_argnums=5)(dp, jfb, jfa, real_as, real_bs, jd)
    _, ggrads = jax.jit(jax.value_and_grad(jcg.g_loss_fn, has_aux=True),
                        static_argnums=4)(gp, dp, real_as, real_bs, jd, vp,
                                          jax.random.PRNGKey(0))
    w = jnp.asarray(jd.loss_g_weights)

    def vgg_terms(fb, fa, vp, real_bs, real_as):
        return H.jax_vgg_term(fb, vp, real_bs, w) + H.jax_vgg_term(
            fa, vp, real_as, w)
    up_b, up_a = (np.array(u) for u in jax.jit(jax.grad(
        vgg_terms, argnums=(0, 1)))(jouts['fake_bs'], jouts['fake_as'], vp,
                                    real_bs, real_as))
    out['jax_grads'] = (H.flat(dgrads), H.flat(ggrads))
    zvgg = H.zero_vgg()
    ta = H.torch_batch(a)

    def g_loss(st):
        loss, (_, outs) = cg.g_loss_fn(st.nets, ta['A'][None], ta['B_mods'],
                                       d, zvgg)
        return loss + (outs['fake_bs'] * torch.from_numpy(up_b)).sum() + (
            outs['fake_as'] * torch.from_numpy(up_a)).sum()
    # G updates first: its gradients against the initial discriminators
    out['port_grads_same_d'] = H.port_g_grads(
        lambda: cg.create_train_state(d, opt, 1, SEED), out['params0'][1],
        g_loss)
    if ckpt_dir is None:
        return out
    out['shared_after_1'] = H.share_jax_state(ckpt_dir, jstate, state)
    a = arrays(2)
    jstate, jm, _, _ = jax_iteration(jstate, a, jax.random.PRNGKey(1))
    state, metrics, _ = step(state, H.torch_batch(a))
    H.record(out, jstate, jm, state, metrics)
    out['pools'] = [p.images for p in pools_a + pools_b]
    return out


@pytest.fixture(scope='module')
def plain(tmp_path_factory):
    return step_case(dict(KW, use_dropout=False),
                     str(tmp_path_factory.mktemp('jax_step1')))


@pytest.fixture(scope='module')
def dropout():
    with H.shared_dropout() as calls:
        out = step_case(dict(KW, use_dropout=True))
    out['calls'] = dict(calls)
    return out


CASES = ['plain', 'dropout']


@pytest.mark.parametrize('case', CASES)
def test_losses_match_jax(request, case):
    H.check_losses(request.getfixturevalue(case), 0)


@pytest.mark.parametrize('case', CASES)
def test_gradients_match_jax(request, case):
    H.check_grad_tensors(request.getfixturevalue(case))


@pytest.mark.parametrize('case', CASES)
def test_parameters_after_one_step(request, case):
    H.check_params_after_one_step(request.getfixturevalue(case))


def test_second_iteration_from_the_shared_state(plain):
    """Both steps again, the pools holding each package's fakes of the
    first iteration."""
    H.check_losses(plain, 1)
    H.check_second_step(plain)
    assert all(len(p) == POOL for p in plain['pools'])


def test_dropout_masks_reached_both_packages(dropout):
    assert dropout['calls']['jax'] > 0 and dropout['calls']['port'] > 0


@pytest.mark.parametrize('pool_size', [0, 1, 50])
def test_image_pool_bit_equal_to_jax(pool_size):
    rng = np.random.default_rng(pool_size)
    ours, theirs = cg.ImagePool(pool_size, 7), jcg.ImagePool(pool_size, 7)
    for _ in range(40):
        images = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
        np.testing.assert_array_equal(ours.query(images),
                                      theirs.query(images))
    assert len(ours.images) == len(theirs.images) == min(pool_size, 120)
    for x, y in zip(ours.images, theirs.images):
        np.testing.assert_array_equal(x, y)


def _state_and_batch(seed=3):
    d = cg.CycleGANDef(**dict(KW, use_dropout=False))
    opt = Options(d_params=dict(TRAIN_DEFAULTS, pool_size=POOL))
    return d, opt, cg.create_train_state(d, opt, 1, SEED), \
        H.torch_batch(arrays(seed))


def test_quirk_g_updates_first_and_the_d_step_counts():
    """The G step leaves the discriminators and the step count as they
    were; the D step moves the discriminators and counts the step."""
    d, _, state, batch = _state_and_batch()
    g_step, d_step = cg.make_train_steps(d, vgg_t.VGG19Features())
    d0 = [p.detach().clone() for p in state.d_params]
    g0 = [p.detach().clone() for p in state.g_params]
    real_as, real_bs = cg.real_pair(batch, d)
    state, _, outs = g_step(state, real_as, real_bs)
    assert state.step == 0 and state.g_opt.count == 1
    assert all(torch.equal(a, b) for a, b in zip(d0, state.d_params))
    assert not any(torch.equal(a, b) for a, b in zip(g0, state.g_params))
    state, _ = d_step(state, outs['fake_bs'], outs['fake_as'], real_as,
                      real_bs)
    assert state.step == 1 and state.d_opt.count == 1


def test_quirk_d_sees_the_pooled_fakes(monkeypatch):
    """The loop's step hands the D step what the pools return, which after the
    first iteration differs from the current fakes where a pool swapped."""
    d, opt, state, _ = _state_and_batch()
    seen, queried = [], []
    make = cg.make_train_steps

    def spy_steps(*a):
        g_step, d_step = make(*a)

        def spy_g(*args):
            res = g_step(*args)
            seen.append(('fakes', res[2]['fake_bs'].clone()))
            return res

        def spy_d(state, fb, fa, *rest):
            seen.append(('pooled', fb.clone()))
            return d_step(state, fb, fa, *rest)
        return spy_g, spy_d
    monkeypatch.setattr(cg, 'make_train_steps', spy_steps)
    step = train_loop.cyclegan_step(cg, d, vgg_t.VGG19Features(), opt, SEED)
    for seed in (3, 4, 5):
        state, _, _ = step(state, H.torch_batch(arrays(seed)))
    fakes = [t for k, t in seen if k == 'fakes']
    pooled = [t for k, t in seen if k == 'pooled']
    assert len(fakes) == len(pooled) == 3
    torch.testing.assert_close(pooled[0][0, 0], fakes[0][0, 0], rtol=0,
                               atol=0)
    assert any(not torch.equal(p, f) for p, f in zip(pooled[1:], fakes[1:]))


def test_quirk_label_smoothing_scales_the_g_target():
    """G_A with a zero VGG is lsgan against the smoothed target 0.9."""
    d, _, state, batch = _state_and_batch()
    real_as, real_bs = cg.real_pair(batch, d)
    with torch.no_grad():
        _, (terms, outs) = cg.g_loss_fn(state.nets, real_as, real_bs, d,
                                        H.zero_vgg())
        p = state.nets.DA[0](outs['fake_bs'][0].movedim(-1, 1))
    torch.testing.assert_close(terms['G_A'], ((p - 0.9) ** 2).mean())
    torch.testing.assert_close(terms['G_A'],
                               losses.gan_loss(p, True, 'lsgan', 0.1))
    assert not torch.allclose(terms['G_A'], ((p - 1.0) ** 2).mean())


def _unaligned(root, phase='train', n=3, size=40, seed=0):
    rng = np.random.default_rng(seed)
    for sub in (f'{phase}A', f'{phase}B1'):
        os.makedirs(root / sub, exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)
                            ).save(root / sub / f'{i}.png')


def test_unaligned_and_single_datasets_equal_jax(tmp_path):
    """The unaligned loader (the B image drawn from random.Random(seed))
    and the single one, flips off, one seed: equal to JAX's arrays."""
    _unaligned(tmp_path / 'data', n=5)
    params = {**J_DEFAULTS, 'dataroot': str(tmp_path / 'data'),
              'model': 'CycleGAN', 'modalities_no': 1, 'load_size': 36,
              'crop_size': 32, 'batch_size': 2, 'seed': 11, 'no_flip': True,
              'num_threads': 1}
    random.seed(0)
    ours = list(create_dataset(Options(d_params=dict(params), mode='train')))
    random.seed(0)
    theirs = list(j_create_dataset(JOptions(d_params=dict(params),
                                            mode='train')))
    assert len(ours) == len(theirs) == 3
    for x, y in zip(ours, theirs):
        assert x['A_paths'] == y['A_paths']
        for k in ('A', 'B_mods'):
            np.testing.assert_array_equal(x[k], y[k])
    single = types.SimpleNamespace(
        dataroot=str(tmp_path / 'data' / 'trainA'), dataset_mode='single',
        preprocess='resize_and_crop', load_size=32, crop_size=32,
        no_flip=True, batch_size=2, serial_batches=True, num_threads=1,
        rank=0, world_size=1)
    a = list(create_dataset(single, phase='test'))
    b = list(j_create_dataset(single, phase='test'))
    assert [x['A'].shape for x in a] == [(2, 32, 32, 3)] * 3
    for x, y in zip(a, b):
        assert x['A_paths'] == y['A_paths']
        np.testing.assert_array_equal(x['A'], y['A'])


# --seg-gen False: a CycleGAN dir has no seg to postprocess (``test``
# raises for it otherwise, as the JAX command does)
CLI = ['--model', 'CycleGAN', '--modalities-no', '1', '--pool-size', '4',
       '--gan-mode', 'lsgan', '--seg-gen', 'False', '--print-freq', '1',
       '--display-freq', '1']


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp('cg_cli')
    _unaligned(root / 'data', n=2, size=64)
    _unaligned(root / 'data', 'val', n=1, size=64, seed=1)
    run = H.port_train(root / 'data', root / 'ckpt', 'cg', *CLI, '--with-val')
    return root, run


def test_cli_epoch_writes_every_group_and_val_losses(trained):
    _, run = trained
    files = set(os.listdir(run))
    assert {f'latest_net_{g}.npz' for g in ('GA', 'GB', 'DA', 'DB')} | {
        'latest_optim.npz', 'config.json'} <= files
    assert H.optim_step(run) == 2
    log = open(os.path.join(run, 'loss_log.txt')).read()
    assert log.count('cycle_A:') == 2 and 'D_B:' in log
    val = H.val_losses(run)
    assert np.isfinite(val['loss_D']) and 'cycle_B' in val


def test_checkpoint_crosses_packages_and_resumes(trained, tmp_path):
    root, run = trained
    opt = Options(d_params={**TRAIN_DEFAULTS, 'model': 'CycleGAN',
                            'modalities_no': 1, 'netG': 'resnet_2blocks',
                            'ngf': 8, 'ndf': 8}, mode='train')
    state = cg.create_train_state(cg.def_from_opt(opt), opt, 1, 9)
    nets_, optim = H.jax_resume_and_rewrite(run, str(tmp_path / 'jax'),
                                            state, opt)
    assert int(optim['step']) == 2
    assert sorted(nets_) == ['DA', 'DB', 'GA', 'GB']
    for g, tree in nets_.items():
        saved = dict(np.load(os.path.join(run, f'latest_net_{g}.npz')))
        got = H.flat(tree)
        assert sorted(got) == sorted(saved)
        for k, v in got.items():
            np.testing.assert_array_equal(v, saved[k])
    from deepliif_tpu_torch import cli
    st, _ = cli.run_train(dict(
        dataroot=str(root / 'data'), checkpoints_dir=str(tmp_path),
        name='jax', model='CycleGAN', modalities_no=1, pool_size=4,
        gan_mode='lsgan', net_g='resnet_2blocks', ngf=8, ndf=8,
        load_size=64, crop_size=64, scale_size=64, seed=0, device='cpu',
        n_epochs=1, n_epochs_decay=0, continue_train=True, print_freq=100,
        num_threads=1), echo=lambda *_: None)
    assert st.step == 4 and st.g_opt.count == 4 and st.d_opt.count == 4


def test_checkpoint_serves_in_the_port(trained, tmp_path):
    """The trained dir runs through the port's ``test`` command."""
    _, run = trained
    assert H.serve_through_test(run, tmp_path, 64) == ['img_GA_1.png']
