"""SDG training in the port against the JAX package on the CPU.

One and two train steps of the JAX test's TINY SDG model (modalities 2,
input_no 2, so 6 input channels, resnet_6blocks, ngf = ndf = 8, 64^2,
batch 2) against the JAX package's jitted step from the same weights and
VGG (the port's, carried into JAX trees), at the limits of
``test_torch_port_train_step.py`` (losses 1e-4 relative, gradients 1e-3
of each tensor's max |g|, parameters after one step; step 2 from JAX's
state read through the JAX package's files), without dropout and with one
dropout mask per activation shape injected into both packages. The G
gradients are held with the perceptual term's gradient w.r.t. the
generators' outputs taken from JAX (its L1 of VGG features is a step
function of sign(a - b); ``test_torch_port_train_step.py`` holds that
upstream gradient on its own): the port's G loss with a zero VGG plus
<outputs, JAX's upstream gradient>.

The quirk of the JAX package: a batch's 'B_mods' holds M + 1 tiles and
the losses use the first M. Then the SDG rows against the JAX dataset,
and the CLI: one epoch with --with-val, the checkpoint crossing to the
JAX package's --continue-train readers and back, and the checkpoint
run through the port's ``test`` command."""

import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu.config import Options as JOptions
from deepliif_tpu.config import TRAIN_DEFAULTS as J_DEFAULTS
from deepliif_tpu.data import create_dataset as j_create_dataset
from deepliif_tpu.models import sdg as jsdg
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.data import create_dataset
from deepliif_tpu_torch.models import sdg
from deepliif_tpu_torch.nets import vgg as vgg_t

import torch_train_helpers as H

KW = dict(modalities_no=2, input_no=2, net_g=('resnet_6blocks',) * 2,
          ngf=8, ndf=8, loss_g_weights=(0.6, 0.4),
          loss_d_weights=(0.3, 0.7))
M2 = 2


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def arrays(seed):
    rng = np.random.default_rng(seed)
    shape = (H.BATCH, H.SIZE, H.SIZE)
    return {'A': rng.uniform(-1, 1, shape + (6,)).astype(np.float32),
            'B_mods': rng.uniform(-1, 1, (M2 + 1,) + shape + (3,)
                                  ).astype(np.float32)}


def step_case(kw, ckpt_dir=None):
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    d, jd = sdg.SDGDef(**kw), jsdg.SDGDef(**kw)
    state = sdg.create_train_state(d, opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    gp, dp = jstate.g_params, jstate.d_params
    vnet = vgg_t.VGG19Features()
    vp = H.vgg_jax(vnet)
    out = {'kw': kw, 'params0': (H.flat(gp), H.flat(dp)), 'port': [],
           'jax': []}
    jstep = jsdg.make_train_step(jd, g_tx, d_tx, vp)
    step = sdg.make_train_step(d, vnet)
    a = arrays(1)
    jb = H.jax_batch(a)
    jstate, jm, _ = jstep(jstate, jb, jax.random.PRNGKey(0))
    state, metrics, _ = step(state, H.torch_batch(a))
    H.record(out, jstate, jm, state, metrics)
    out['port_d_grads'] = H.grads_jax_layout(state.nets, ('D',))

    mods, _ = jax.jit(lambda g, x: jsdg.generator_forward(
        g, x, jd, train=True, rng=jax.random.PRNGKey(0)))(gp, jb['A'])
    _, dgrads = jax.jit(jax.value_and_grad(jsdg.d_loss_fn, has_aux=True),
                        static_argnums=3)(dp, {'mods': mods}, jb, jd)
    _, ggrads = jax.jit(jax.value_and_grad(jsdg.g_loss_fn, has_aux=True),
                        static_argnums=3)(gp, jstate.d_params, jb, jd, vp,
                                          jax.random.PRNGKey(0))
    w = jd.lambda_feat * jnp.asarray(jd.loss_g_weights)
    up = np.array(jax.jit(jax.grad(H.jax_vgg_term))(
        mods, vp, jb['B_mods'][:M2], w))
    out['jax_grads'] = (H.flat(dgrads), H.flat(ggrads))
    zvgg = H.zero_vgg()

    def g_loss(st):
        loss, (_, g_out) = sdg.g_loss_fn(st.nets, H.torch_batch(a), d, zvgg)
        return loss + (g_out['mods'] * torch.from_numpy(up)).sum()
    out['port_grads_same_d'] = H.port_g_grads(
        lambda: sdg.create_train_state(d, opt, 1, 0), out['jax'][0]['d'],
        g_loss)
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


def test_second_step_from_the_shared_state(plain):
    H.check_losses(plain, 1)
    H.check_second_step(plain)


def test_dropout_masks_reached_both_packages(dropout):
    assert dropout['calls']['jax'] > 0 and dropout['calls']['port'] > 0


def test_quirk_losses_use_the_first_m_of_m_plus_one_tiles():
    """'B_mods' holds M + 1 tiles: changing tile M moves no loss, changing
    tile 0 moves them (and the VGG term is per modality: (M,))."""
    d = sdg.SDGDef(**dict(KW, use_dropout=False))
    nets_ = sdg.create_train_state(d, Options(d_params=dict(
        TRAIN_DEFAULTS)), 1, 0).nets
    vnet = vgg_t.VGG19Features()
    base = H.torch_batch(arrays(3))

    def losses(batch):
        with torch.no_grad():
            g_out = sdg.train_forward(nets_, batch['A'], d)
            gl, (terms, _) = sdg.g_loss_fn(nets_, batch, d, vnet,
                                           g_out=g_out)
            dl_, _ = sdg.d_loss_fn(nets_, g_out, batch, d)
        return gl, dl_, terms
    g0, d0, terms = losses(base)
    assert terms['G_VGG'].shape == (M2,)
    for tile, moves in ((M2, False), (0, True)):
        other = {k: v.clone() for k, v in base.items()}
        other['B_mods'][tile] = -other['B_mods'][tile]
        g1, d1, _ = losses(other)
        assert (not torch.equal(g0, g1)) == moves
        assert (not torch.equal(d0, d1)) == moves


def test_sdg_rows_equal_jax(tmp_path):
    """SDG rows A1 A2 | B1 B2 B3 (input_no 2, M + 1 targets), flips off,
    one seed: the port's batches equal the JAX dataset's arrays."""
    H.write_rows(str(tmp_path / 'data' / 'train'), 5, count=3, size=40,
                 seed=5)
    params = {**J_DEFAULTS, 'dataroot': str(tmp_path / 'data'),
              'model': 'SDG', 'modalities_no': 2, 'input_no': 2,
              'load_size': 36, 'crop_size': 32, 'batch_size': 2, 'seed': 3,
              'no_flip': True, 'num_threads': 1}
    random.seed(0)
    ours = list(create_dataset(Options(d_params=dict(params), mode='train')))
    random.seed(0)
    theirs = list(j_create_dataset(JOptions(d_params=dict(params),
                                            mode='train')))
    assert len(ours) == len(theirs) == 2
    for x, y in zip(ours, theirs):
        assert sorted(x) == sorted(y) == ['A', 'A_paths', 'B_mods']
        assert x['A'].shape == (2, 32, 32, 6)
        assert x['B_mods'].shape == (3, 2, 32, 32, 3)
        for k in ('A', 'B_mods'):
            np.testing.assert_array_equal(x[k], y[k])


CLI = ['--model', 'SDG', '--modalities-no', '2', '--input-no', '2',
       '--print-freq', '1']


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp('sdg_cli')
    H.write_rows(str(root / 'data' / 'train'), 5)
    H.write_rows(str(root / 'data' / 'val'), 5, count=1, seed=1)
    run = H.port_train(root / 'data', root / 'ckpt', 'sdg', *CLI,
                       '--with-val')
    return root, run


def test_cli_epoch_writes_every_group_and_val_losses(trained):
    _, run = trained
    files = set(os.listdir(run))
    assert {'latest_net_G.npz', 'latest_net_D.npz', 'latest_optim.npz',
            'config.json'} <= files
    assert 'latest_net_GS.npz' not in files
    assert H.optim_step(run) == 2
    log = open(os.path.join(run, 'loss_log.txt')).read()
    assert log.count('G_VGG:') == 2 and 'D_real:' in log
    val = H.val_losses(run)
    assert np.isfinite(val['loss_G']) and 'G_VGG' in val


def test_checkpoint_crosses_packages_and_resumes(trained, tmp_path):
    root, run = trained
    opt = Options(d_params={**TRAIN_DEFAULTS, 'model': 'SDG',
                            'modalities_no': 2, 'input_no': 2,
                            'netG': 'resnet_2blocks', 'ngf': 8, 'ndf': 8},
                  mode='train')
    state = sdg.create_train_state(sdg.def_from_opt(opt), opt, 1, 9)
    nets_, optim = H.jax_resume_and_rewrite(run, str(tmp_path / 'jax'),
                                            state, opt)
    assert int(optim['step']) == 2 and sorted(nets_) == ['D', 'G']
    for g, tree in nets_.items():
        saved = dict(np.load(os.path.join(run, f'latest_net_{g}.npz')))
        got = H.flat(tree)
        assert sorted(got) == sorted(saved)
        for k, v in got.items():
            np.testing.assert_array_equal(v, saved[k])
    from deepliif_tpu_torch import cli
    st, _ = cli.run_train(dict(
        dataroot=str(root / 'data'), checkpoints_dir=str(tmp_path),
        name='jax', model='SDG', modalities_no=2, input_no=2,
        net_g='resnet_2blocks', ngf=8, ndf=8, load_size=64, crop_size=64,
        scale_size=64, seed=0, device='cpu', n_epochs=1, n_epochs_decay=0,
        continue_train=True, print_freq=100, num_threads=1),
        echo=lambda *_: None)
    assert st.step == 4 and st.g_opt.count == 4 and st.d_opt.count == 4


def test_checkpoint_serves_in_the_port(trained, tmp_path):
    """The trained dir runs through the port's ``test`` command."""
    _, run = trained
    assert H.serve_through_test(run, tmp_path, 128) == [
        'img.json', 'img_mod1.png', 'img_mod2.png']
