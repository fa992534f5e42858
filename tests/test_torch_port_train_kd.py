"""DeepLIIFKD training in the port against the JAX package on the CPU.

One and two train steps of a TINY student (the DeepLIIF topology:
modalities 1, resnet_6blocks, unet_32 seg nets, ngf = ndf = 8, 64^2,
batch 2) distilled from a frozen teacher of the same topology and other
weights, against the JAX package's jitted KD step from the same weights
and VGG, at the limits of ``test_torch_port_train_step.py`` (losses 1e-4
relative, gradients 1e-3 of each tensor's max |g|, parameters after one
step; step 2 from JAX's state read through the JAX package's files),
without dropout and with one dropout mask per activation shape injected
into both packages (the translators' blocks; the seg nets' dropout is
the flagship's ``train_forward``, held by
``test_torch_port_train_dropout.py``). The G gradients are held with the
perceptual term's gradient w.r.t. the student's modalities taken from JAX
(the port's G loss with a zero VGG plus <modalities, JAX's upstream
gradient>). The case sets gan_mode lsgan and gan_mode_s vanilla, and
loss_G_weights (0.7, 0.3), so that the JAX package's quirks show
against it: the G side's GAN criteria are vanilla (modalities) and lsgan
(seg) whatever the options say, and the seg term is weighted by
loss_G_weights[m - 1].

``kd_kl`` against JAX's and ``torch.nn.KLDivLoss(reduction='batchmean')``;
``load_teacher`` from a native npz dir and from a reference-layout torch
dir (TINY, modalities 2) against JAX's ``load_teacher`` (its template
of the nets' shapes made without a random draw) and ``teacher_forward``;
the KD term counting the M modalities, the M + 1 branches and the
aggregate, x 10;
the CLI: one epoch with --with-val (the losses and the cell-count RMSE),
the checkpoint crossing to the JAX package's --continue-train readers and
back, and the checkpoint run through the port's ``test`` command."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu.models import deepliif as jdl, deepliif_kd as jkd
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.models import deepliif as dl, deepliif_kd as kd
from deepliif_tpu_torch.nets import losses
from deepliif_tpu_torch.nets import vgg as vgg_t

import torch_train_helpers as H

KW = dict(modalities_no=1, net_g=('resnet_6blocks',),
          net_gs=('unet_32',) * 2, ngf=8, ndf=8, seg_weights=(0.6, 0.4),
          loss_g_weights=(0.7, 0.3), loss_d_weights=(0.5, 0.5),
          gan_mode='lsgan', gan_mode_s='vanilla')
M1 = 1
TEACHER_SEED = 5


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def teacher_nets(d, seed=TEACHER_SEED):
    nets_ = dl.init_nets(d, torch.Generator().manual_seed(seed),
                         with_discriminators=False).eval()
    return nets_.requires_grad_(False)


def step_case(kw, ckpt_dir=None):
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    d, jd = dl.DeepLIIFDef(**kw), jdl.DeepLIIFDef(**kw)
    tnets = teacher_nets(dataclasses.replace(d, use_dropout=False))
    jt = jdl.DeepLIIFDef(**dict(kw, use_dropout=False))
    tp = H.jax_params(tnets, ('G', 'GS'))
    state = kd.create_train_state(d, opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    gp, dp = jstate.g_params, jstate.d_params
    vnet = vgg_t.VGG19Features()
    vp = H.vgg_jax(vnet)
    out = {'kw': kw, 'params0': (H.flat(gp), H.flat(dp)), 'port': [],
           'jax': []}
    jstep = jkd.make_train_step(jd, g_tx, d_tx, vp, tp, jt)
    teacher = (tnets, dataclasses.replace(d, use_dropout=False))
    step = kd.make_train_step(d, vnet, teacher)
    a = H.batch_arrays(1, M1)
    jb = H.jax_batch(a)
    jstate, jm, _ = jstep(jstate, jb, jax.random.PRNGKey(0))
    state, metrics, _ = step(state, H.torch_batch(a))
    H.record(out, jstate, jm, state, metrics)
    out['port_d_grads'] = H.grads_jax_layout(state.nets, ('D', 'DS'))

    mods, seg = jax.jit(lambda g, x: jdl.generator_forward(
        g, x, jd, train=True, rng=jax.random.PRNGKey(0)))(gp, jb['A'])
    _, dgrads = jax.jit(jax.value_and_grad(jdl.d_loss_fn, has_aux=True),
                        static_argnums=3)(dp, {'mods': mods, 'seg': seg},
                                          jb, jd)
    _, ggrads = jax.jit(jax.value_and_grad(jkd.g_loss_fn, has_aux=True),
                        static_argnums=(3, 6))(
        gp, jstate.d_params, jb, jd, vp, tp, jt, jax.random.PRNGKey(0))
    w = jd.lambda_feat * jnp.asarray(jd.loss_g_weights[:M1])
    up = np.array(jax.jit(jax.grad(H.jax_vgg_term))(mods, vp, jb['B_mods'],
                                                    w))
    out['jax_grads'] = (H.flat(dgrads), H.flat(ggrads))
    zvgg = H.zero_vgg()

    def g_loss(st):
        loss, (_, g_out) = kd.g_loss_fn(st.nets, H.torch_batch(a), d, zvgg,
                                        teacher)
        return loss + (g_out['mods'] * torch.from_numpy(up)).sum()
    out['port_grads_same_d'] = H.port_g_grads(
        lambda: kd.create_train_state(d, opt, 1, 0), out['jax'][0]['d'],
        g_loss)
    if ckpt_dir is None:
        return out
    out['shared_after_1'] = H.share_jax_state(ckpt_dir, jstate, state)
    a = H.batch_arrays(2, M1)
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


@pytest.mark.parametrize('batch', [1, 3])
def test_kd_kl_matches_jax_and_kldiv_batchmean(batch):
    rng = np.random.default_rng(batch)
    s = rng.standard_normal((batch, 8, 8, 3)).astype(np.float32)
    t = rng.standard_normal((batch, 8, 8, 3)).astype(np.float32)
    ours = float(kd.kd_kl(torch.from_numpy(s), torch.from_numpy(t)))
    theirs = float(jkd.kd_kl(jnp.asarray(s), jnp.asarray(t)))
    ref = float(torch.nn.KLDivLoss(reduction='batchmean')(
        torch.log_softmax(torch.from_numpy(s).reshape(batch, -1), -1),
        torch.softmax(torch.from_numpy(t).reshape(batch, -1), -1)))
    assert abs(ours - theirs) <= 1e-6 * abs(theirs)
    assert abs(ours - ref) <= 1e-6 * abs(ref)


def _state_and_batch():
    d = dl.DeepLIIFDef(**dict(KW, use_dropout=False))
    state = kd.create_train_state(d, Options(d_params=dict(TRAIN_DEFAULTS)),
                                  1, 0)
    return d, state, H.torch_batch(H.batch_arrays(3, M1))


def test_quirks_of_the_g_loss():
    """G_GAN is vanilla and G_GAN_S lsgan (gan_mode lsgan, gan_mode_s
    vanilla here); the seg term is weighted by loss_G_weights[m - 1]; the
    KD term sums the M modalities, the M + 1 branches and the aggregate,
    and enters the loss x 10."""
    d, state, batch = _state_and_batch()
    tnets = teacher_nets(d)
    with torch.no_grad():
        g_out = kd.student_forward_with_branches(state.nets, batch['A'], d)
        loss, (t, _) = kd.g_loss_fn(state.nets, batch, d, H.zero_vgg(),
                                    (tnets, d), g_out=g_out)
        tm, ts, tss = kd.teacher_forward(tnets, batch['A'], d)
        x = batch['A'].movedim(-1, 1)
        preds = dl._d_preds(state.nets.D, [x] * M1, [
            y.movedim(-1, 1) for y in g_out['mods']])
        real = [y.movedim(-1, 1) for y in batch['B_mods']]
        pseg = dl._d_pred_seg(state.nets.DS, x, real,
                              g_out['seg'].movedim(-1, 1), d)
    torch.testing.assert_close(t['G_GAN'], torch.stack(
        [losses.gan_loss(p, True, 'vanilla') for p in preds]))
    torch.testing.assert_close(t['G_GAN_S'],
                               losses.gan_loss(pseg, True, 'lsgan'))
    assert g_out['segs'].shape[0] == M1 + 1 and tss.shape[0] == M1 + 1
    want_kd = sum(kd.kd_kl(a, b) for a, b in zip(g_out['mods'], tm)) + sum(
        kd.kd_kl(a, b) for a, b in zip(g_out['segs'], tss)) + kd.kd_kl(
        g_out['seg'], ts)
    torch.testing.assert_close(t['G_KD'], want_kd)
    w = d.loss_g_weights
    want = ((t['G_GAN'] + t['G_L1'] + t['G_VGG']) * torch.tensor(w[:M1])
            ).sum() + (t['G_GAN_S'] + t['G_L1_S']) * w[M1 - 1] \
        + 10 * t['G_KD']
    torch.testing.assert_close(loss, want)
    assert not torch.allclose(loss, want + (t['G_GAN_S'] + t['G_L1_S'])
                              * (w[M1] - w[M1 - 1]))


def _teacher_dirs(root, d, nets_):
    """The teacher as a native npz dir (the JAX package's writer) and as a
    reference-layout torch dir (latest_net_G{i}.pth, latest_net_GS{i}.pth),
    with one config.json."""
    from deepliif_tpu.utils import checkpoints as jck
    cfg = {'model': 'DeepLIIF', 'modalities_no': 2, 'seg_gen': True,
           'seg_no': 1, 'input_no': 1, 'netG': 'resnet_6blocks',
           'net_gs': 'unet_32', 'ngf': 8, 'norm': 'batch',
           'no_dropout': True, 'padding': 'zero',
           'upsample': 'convtranspose', 'scale_size': 64,
           'seg_weights': list(d.seg_weights),
           'modalities_names': ['IHC', 'A', 'B']}
    native, ref = os.path.join(root, 'native'), os.path.join(root, 'ref')
    for path in (native, ref):
        os.makedirs(path)
        with open(os.path.join(path, 'config.json'), 'w') as f:
            json.dump(cfg, f)
    jck.save_networks(native, H.jax_params(nets_, ('G', 'GS')))
    for i, net in enumerate(nets_.G):
        torch.save(net.state_dict(), os.path.join(ref,
                                                  f'latest_net_G{i + 1}.pth'))
    for i, net in enumerate(nets_.GS):
        torch.save(net.state_dict(), os.path.join(ref,
                                                  f'latest_net_GS{i}.pth'))
    return native, ref


@pytest.fixture(scope='module')
def teacher_dirs(tmp_path_factory):
    d = dl.DeepLIIFDef(**dict(H.TINY, use_dropout=False))
    return d, _teacher_dirs(str(tmp_path_factory.mktemp('teacher')), d,
                            teacher_nets(d))


_jax_teacher_forward = jax.jit(jkd.teacher_forward, static_argnums=2)


def _shape_template(init):
    """The JAX package's ``init_params`` as zeros of its shapes
    (``jax.eval_shape``: no random draw): ``load_teacher`` reads only the
    template's structure and shapes from it."""
    def like(key, d, with_discriminators=True):
        return jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(lambda k: init(k, d, with_discriminators), key))
    return like


@pytest.mark.parametrize('layout', [0, 1], ids=['native', 'reference'])
def test_load_teacher_matches_jax(teacher_dirs, layout):
    d, dirs = teacher_dirs
    md = dirs[layout]
    nets_, td = kd.load_teacher(md, 'cpu')
    assert not nets_.training and td.modalities_no == 2
    assert not any(p.requires_grad for p in nets_.parameters())
    with pytest.MonkeyPatch.context() as mp:
        # the first jax.random draw of a process costs ~13 s on this CPU
        mp.setattr(jdl, 'init_params', _shape_template(jdl.init_params))
        tp, jt = jkd.load_teacher(md)
    x = H.batch_arrays(4)['A']
    got = kd.teacher_forward(nets_, torch.from_numpy(x), td)
    want = _jax_teacher_forward(tp, jnp.asarray(x), jt)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert H.rel(g.numpy(), w) <= 1e-5


CLI = ['--model', 'DeepLIIFKD', '--modalities-no', '2', '--print-freq',
       '1', '--net-g', 'resnet_6blocks']


@pytest.fixture(scope='module')
def trained(tmp_path_factory, teacher_dirs):
    from torch_train_helpers import write_rows
    root = tmp_path_factory.mktemp('kd_cli')
    write_rows(str(root / 'data' / 'train'), 4)
    write_rows(str(root / 'data' / 'val'), 4, count=2, seed=1)
    with open(root / 'data' / 'val' / 'metrics.json', 'w') as f:
        json.dump({f'r{i}': {'num_total': 3, 'num_pos': 1, 'num_neg': 2,
                             'percent_pos': 33.3} for i in range(2)}, f)
    run = H.port_train(root / 'data', root / 'ckpt', 'kd', *CLI,
                       '--model-dir-teacher', teacher_dirs[1][0],
                       '--with-val')
    return root, run


def test_cli_epoch_writes_every_group_val_losses_and_rmse(trained):
    _, run = trained
    files = set(os.listdir(run))
    assert {f'latest_net_{g}.npz' for g in ('G', 'GS', 'D', 'DS')} | {
        'latest_optim.npz', 'config.json'} <= files
    assert H.optim_step(run) == 2
    log = open(os.path.join(run, 'loss_log.txt')).read()
    assert log.count('G_KD:') == 2
    val = H.val_losses(run)
    assert np.isfinite(val['loss_G']) and 'G_KD' not in val
    with open(os.path.join(run, 'metrics_log.json')) as f:
        assert 'rmse_num_total' in json.load(f)['metrics'][0]['metrics']


def test_kd_without_teacher_raises(tmp_path):
    H.write_rows(str(tmp_path / 'data' / 'train'), 4, count=1)
    with pytest.raises(ValueError, match='model-dir-teacher'):
        H.port_train(tmp_path / 'data', tmp_path / 'ckpt', 'kd', *CLI)


def test_checkpoint_crosses_packages_and_resumes(trained, teacher_dirs,
                                                 tmp_path):
    root, run = trained
    opt = Options(d_params={**TRAIN_DEFAULTS, 'model': 'DeepLIIFKD',
                            'modalities_no': 2, 'netG': 'resnet_6blocks',
                            'net_gs': 'unet_32', 'ngf': 8, 'ndf': 8,
                            'seg_weights': [1 / 3] * 3,
                            'loss_G_weights': [1 / 3] * 3,
                            'loss_D_weights': [1 / 3] * 3}, mode='train')
    state = kd.create_train_state(kd.def_from_opt(opt), opt, 1, 9)
    nets_, optim = H.jax_resume_and_rewrite(run, str(tmp_path / 'jax'),
                                            state, opt)
    assert int(optim['step']) == 2
    assert sorted(nets_) == ['D', 'DS', 'G', 'GS']
    for g, tree in nets_.items():
        saved = dict(np.load(os.path.join(run, f'latest_net_{g}.npz')))
        got = H.flat(tree)
        assert sorted(got) == sorted(saved)
        for k, v in got.items():
            np.testing.assert_array_equal(v, saved[k])
    from deepliif_tpu_torch import cli
    st, _ = cli.run_train(dict(
        dataroot=str(root / 'data'), checkpoints_dir=str(tmp_path),
        name='jax', model='DeepLIIFKD', modalities_no=2,
        model_dir_teacher=teacher_dirs[1][1], net_g='resnet_6blocks',
        net_gs='unet_32', ngf=8, ndf=8, load_size=64, crop_size=64,
        scale_size=64, seed=0, device='cpu', n_epochs=1, n_epochs_decay=0,
        continue_train=True, print_freq=100, num_threads=1),
        echo=lambda *_: None)
    assert st.step == 4 and st.g_opt.count == 4 and st.d_opt.count == 4


def test_checkpoint_serves_in_the_port(trained, tmp_path):
    """The trained student dir runs through the port's ``test`` command."""
    _, run = trained
    files = H.serve_through_test(run, tmp_path)
    assert {'img.json', 'img_Seg.png', 'img_mod1.png', 'img_mod2.png'} <= \
        set(files), files
