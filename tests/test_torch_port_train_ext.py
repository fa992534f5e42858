"""DeepLIIFExt training in the port against the JAX package on the CPU.

One and two train steps of the JAX test's TINY Ext model (modalities 2,
resnet_6blocks translators, unet_32 seg nets, ngf = ndf = 8, 64^2, batch
2; loss_G_weights (0.6, 0.4), so that the segs' uniform 1/M weights show)
against the JAX package's jitted step from the same weights (drawn by the
port, carried into JAX trees), at the limits of
``test_torch_port_train_step.py``: every loss term within 1e-4 relative;
D gradients at the same parameters and G gradients against the same
(JAX's updated) discriminators per tensor within 1e-3 of the tensor's max
|g|; after one step the parameters within 1e-6 on at least 99.9 % of all
elements and within 2 lr everywhere; step 2 from JAX's state after step 1,
read through the JAX package's checkpoint files. Once without dropout and
once with one dropout mask per activation shape injected into both
packages (unet_64 seg nets, whose depth-4 block drops out).

The quirks of the JAX package: the G side's seg GAN term uses
``gan_mode`` while the D side uses ``gan_mode_s``; the seg weights are a
uniform 1/M; no VGG term. Then the rows of the aligned dataset against
the JAX dataset, and the CLI: one epoch with --with-val, the checkpoint
read by the JAX package's --continue-train readers and written back by
its writers, the port's --continue-train from those files, and the
checkpoint run through the port's ``test`` command. The JAX steps are
compiled once per case for the file."""

import os
import random

import numpy as np
import pytest
import torch

import jax

from deepliif_tpu.config import Options as JOptions
from deepliif_tpu.config import TRAIN_DEFAULTS as J_DEFAULTS
from deepliif_tpu.data import create_dataset as j_create_dataset
from deepliif_tpu.models import deepliif_ext as jext
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.data import create_dataset
from deepliif_tpu_torch.models import deepliif_ext as ext
from deepliif_tpu_torch.nets import losses

import torch_train_helpers as H

KW = dict(modalities_no=2, net_g=('resnet_6blocks',) * 2,
          net_gs=('unet_32',) * 2, ngf=8, ndf=8,
          loss_g_weights=(0.6, 0.4), loss_d_weights=(0.3, 0.7))
M2 = 2


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
            'B_mods': rng.uniform(-1, 1, (M2,) + shape).astype(np.float32),
            'B_segs': rng.uniform(-1, 1, (M2,) + shape).astype(np.float32)}


def step_case(kw, ckpt_dir=None):
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    d, jd = ext.DeepLIIFExtDef(**kw), jext.DeepLIIFExtDef(**kw)
    state = ext.create_train_state(d, opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    gp, dp = jstate.g_params, jstate.d_params
    out = {'kw': kw, 'params0': (H.flat(gp), H.flat(dp)), 'port': [],
           'jax': []}
    jstep = jext.make_train_step(jd, g_tx, d_tx)
    step = ext.make_train_step(d)
    a = arrays(1)
    jb = H.jax_batch(a)
    jstate, jm, _ = jstep(jstate, jb, jax.random.PRNGKey(0))
    state, metrics, g_out = step(state, H.torch_batch(a))
    H.record(out, jstate, jm, state, metrics)
    out['port_d_grads'] = H.grads_jax_layout(state.nets, ('D', 'DS'))
    out['g_out_keys'] = sorted(g_out)

    # the G loss's own forward (the initial generators, rng 0) gives the D
    # loss its fakes
    (_, (_, fakes)), ggrads = jax.jit(
        jax.value_and_grad(jext.g_loss_fn, has_aux=True), static_argnums=3)(
            gp, jstate.d_params, jb, jd, jax.random.PRNGKey(0))
    _, dgrads = jax.jit(jax.value_and_grad(jext.d_loss_fn, has_aux=True),
                        static_argnums=3)(dp, fakes, jb, jd)
    out['jax_grads'] = (H.flat(dgrads), H.flat(ggrads))
    out['port_grads_same_d'] = H.port_g_grads(
        lambda: ext.create_train_state(d, opt, 1, 0), out['jax'][0]['d'],
        lambda st: ext.g_loss_fn(st.nets, H.torch_batch(a), d)[0])
    if ckpt_dir is None:
        return out
    out['shared_after_1'] = H.share_jax_state(ckpt_dir, jstate, state)
    a = arrays(2)
    jstate, jm, _ = jstep(jstate, H.jax_batch(a), jax.random.PRNGKey(1))
    state, metrics, _ = step(state, H.torch_batch(a))
    H.record(out, jstate, jm, state, metrics)
    return out


@pytest.fixture(scope='module')
def plain(tmp_path_factory):
    return step_case(dict(KW, use_dropout=False),
                     str(tmp_path_factory.mktemp('jax_step1')))


@pytest.fixture(scope='module')
def dropout():
    with H.shared_dropout() as calls:
        out = step_case(dict(KW, use_dropout=True, net_gs=('unet_64',) * 2))
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


def test_second_step_from_the_shared_state(plain):
    H.check_losses(plain, 1)
    H.check_second_step(plain)


def test_dropout_masks_reached_both_packages(dropout):
    assert dropout['calls']['jax'] > 0 and dropout['calls']['port'] > 0


def test_step_returns_mods_and_segs(plain):
    assert plain['g_out_keys'] == ['mods', 'segs']
    assert 'G_VGG' not in plain['port'][0]['metrics']


def _nets_and_batch():
    d = ext.DeepLIIFExtDef(**dict(KW, use_dropout=False))
    nets_ = ext.create_train_state(d, Options(d_params=dict(
        TRAIN_DEFAULTS)), 1, 0).nets
    return d, nets_, H.torch_batch(arrays(3))


def test_quirk_seg_gan_of_g_uses_gan_mode():
    """G's seg GAN term is ``gan_mode`` (vanilla here), D's ``gan_mode_s``
    (lsgan): the terms equal those criteria on DS's predictions."""
    d, nets_, batch = _nets_and_batch()
    with torch.no_grad():
        g_out = ext.train_forward(nets_, batch['A'], d)
        _, (terms, _) = ext.g_loss_fn(nets_, batch, d, g_out=g_out)
        _, dterms = ext.d_loss_fn(nets_, g_out, batch, d)
        x = batch['A'].movedim(-1, 1)
        real = [t.movedim(-1, 1) for t in batch['B_mods']]
        conds = ext._cond_seg(x, real)
        preds = ext._preds(nets_.DS, conds, [t.movedim(-1, 1)
                                             for t in g_out['segs']])
    want_g = torch.stack([losses.gan_loss(p, True, 'vanilla') for p in preds])
    want_d = torch.stack([losses.gan_loss(p, False, 'lsgan') for p in preds])
    torch.testing.assert_close(terms['GS_GAN'], want_g)
    torch.testing.assert_close(dterms['DS_fake'], want_d)
    assert not torch.allclose(terms['GS_GAN'], torch.stack(
        [losses.gan_loss(p, True, 'lsgan') for p in preds]))


def test_quirk_seg_weights_are_uniform():
    """loss_G = sum((G_GAN + G_L1) w_g) + sum((GS_GAN + GS_L1) / M), with
    w_g = loss_G_weights (0.6, 0.4) for the modalities only."""
    d, nets_, batch = _nets_and_batch()
    with torch.no_grad():
        loss, (t, _) = ext.g_loss_fn(nets_, batch, d)
    w = torch.tensor(d.loss_g_weights)
    want = ((t['G_GAN'] + t['G_L1']) * w).sum() + (
        (t['GS_GAN'] + t['GS_L1']) / 2).sum()
    torch.testing.assert_close(loss, want)
    assert not torch.allclose(loss, ((t['G_GAN'] + t['G_L1']) * w).sum()
                              + ((t['GS_GAN'] + t['GS_L1']) * w).sum())


def test_aligned_rows_equal_jax(tmp_path):
    """Ext rows A | B1 B2 | BS1 BS2, flips off, one seed: the port's
    batches equal the JAX dataset's arrays."""
    H.write_rows(str(tmp_path / 'data' / 'train'), 5, count=3, size=40,
                 seed=4)
    params = {**J_DEFAULTS, 'dataroot': str(tmp_path / 'data'),
              'model': 'DeepLIIFExt', 'modalities_no': 2, 'load_size': 36,
              'crop_size': 32, 'batch_size': 2, 'seed': 7, 'no_flip': True,
              'num_threads': 1}
    random.seed(0)              # the crops' global state
    ours = list(create_dataset(Options(d_params=dict(params), mode='train')))
    random.seed(0)
    theirs = list(j_create_dataset(JOptions(d_params=dict(params),
                                            mode='train')))
    assert len(ours) == len(theirs) == 2
    for x, y in zip(ours, theirs):
        assert sorted(x) == sorted(y) == ['A', 'A_paths', 'B_mods', 'B_segs']
        assert x['B_segs'].shape == (2, 2, 32, 32, 3)
        for k in ('A', 'B_mods', 'B_segs'):
            np.testing.assert_array_equal(x[k], y[k])


CLI = ['--model', 'DeepLIIFExt', '--modalities-no', '2', '--print-freq',
       '1', '--display-freq', '1']


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp('ext_cli')
    H.write_rows(str(root / 'data' / 'train'), 5)
    H.write_rows(str(root / 'data' / 'val'), 5, count=1, seed=1)
    run = H.port_train(root / 'data', root / 'ckpt', 'ext', *CLI,
                       '--with-val')
    return root, run


def test_cli_epoch_writes_every_group_and_val_losses(trained):
    _, run = trained
    files = set(os.listdir(run))
    assert {f'latest_net_{g}.npz' for g in ('G', 'GS', 'D', 'DS')} | {
        'latest_optim.npz', 'config.json'} <= files
    assert H.optim_step(run) == 2
    log = open(os.path.join(run, 'loss_log.txt')).read()
    assert log.count('GS_GAN:') == 2 and 'DS_real:' in log
    val = H.val_losses(run)
    assert np.isfinite(val['loss_G']) and 'GS_L1' in val
    images = os.listdir(os.path.join(run, 'web', 'images'))
    assert any(f.endswith('fake_BS_2.png') for f in images), images


def _cli_state(root):
    opt = Options(d_params={**TRAIN_DEFAULTS, 'model': 'DeepLIIFExt',
                            'modalities_no': 2, 'netG': 'resnet_2blocks',
                            'net_gs': 'unet_32', 'ngf': 8, 'ndf': 8},
                  mode='train')
    return ext.create_train_state(ext.def_from_opt(opt), opt, 1, 9), opt


def test_checkpoint_crosses_packages_and_resumes(trained, tmp_path):
    """The JAX package's --continue-train readers take the port's files
    (every group's values, step 2); its writers' files resume the port's
    --continue-train (step 2 + 2, the nets those values)."""
    root, run = trained
    state, opt = _cli_state(root)
    nets_, optim = H.jax_resume_and_rewrite(run, str(tmp_path / 'jax'),
                                            state, opt)
    assert int(optim['step']) == 2
    saved = {g: dict(np.load(os.path.join(run, f'latest_net_{g}.npz')))
             for g in ('G', 'GS', 'D', 'DS')}
    assert sorted(nets_) == sorted(saved)
    for g, tree in nets_.items():
        got = H.flat(tree)
        assert sorted(got) == sorted(saved[g])
        for k, v in got.items():
            np.testing.assert_array_equal(v, saved[g][k])
    from deepliif_tpu_torch import cli
    st, _ = cli.run_train(dict(
        dataroot=str(root / 'data'), checkpoints_dir=str(tmp_path),
        name='jax', model='DeepLIIFExt', modalities_no=2,
        net_g='resnet_2blocks', net_gs='unet_32', ngf=8, ndf=8,
        load_size=64, crop_size=64, scale_size=64, seed=0, device='cpu',
        n_epochs=1, n_epochs_decay=0, continue_train=True, print_freq=100,
        num_threads=1), echo=lambda *_: None)
    assert st.step == 4 and st.g_opt.count == 4 and st.d_opt.count == 4


def test_checkpoint_serves_in_the_port(trained, tmp_path):
    """The trained dir runs through the port's ``test`` command."""
    _, run = trained
    assert H.serve_through_test(run, tmp_path, 64) == ['img.json'] + [
        f'img_Seg{i}{s}.png' for i in (1, 2)
        for s in ('', '_Overlaid', '_Refined')] + ['img_mod1.png',
                                                   'img_mod2.png']
