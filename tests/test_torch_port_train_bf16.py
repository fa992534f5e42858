"""bfloat16 training in the port against the JAX package on the CPU.

The JAX test's TINY DeepLIIF model (modalities 2, resnet_6blocks, unet_32,
ngf = ndf = 8, 64^2, batch 2, no dropout) at ``precision='bfloat16'``: every
net, the discriminators and the perceptual term's VGG of the outputs
included, runs in bfloat16 with float32 parameters, norm statistics and
losses (the JAX ``d.dtype``). The same weights (drawn by the port, carried
into JAX trees), VGG and batches in both packages.

bfloat16 rounds at different points in the two packages (XLA fuses and
keeps excess precision; the port rounds per op), so neither matches the
other bit for bit. Held:
- the loss terms of one step, and of a second step from JAX's state read
  through the JAX package's files, within LOSS_TOL relative of JAX's
  bfloat16 step (the largest seen: 9.3e-3);
- the gradients by an accuracy bound: for every gradient tensor (D at the
  initial weights, G against the initial discriminators), the port's
  bfloat16 distance from JAX's float32 gradient (relative L2) is at most
  BOUND_FACTOR times JAX's own bfloat16 distance from it. The sound port
  passes (the largest ratio seen: 1.35; the median 1.0); a small
  systematic fault fails: every train-mode batch norm with an epsilon of
  1e-3 in place of 1e-5 (ratios up to 19). Rounding the norm statistics
  to bfloat16, or taking the variance as E[x^2] - mean^2 in bfloat16, is
  within the bfloat16 noise of these gradients (ratios up to 1.6, median
  0.97), so the bound cannot see it;
- a bfloat16 run with spectral norm of the port's ``train`` read by the
  JAX package's --continue-train readers (its optimizer state's u
  moments included) and stepped once in each package: the losses within
  LOSS_TOL, the parameters within 2.12 lr, the port's refresh of JAX's
  updated weights JAX's u within 1e-5.
The other families train in float32 at ``--precision bfloat16`` (the JAX
``def_from_opt`` of DeepLIIFExt, SDG and CycleGAN takes no dtype): their
runs through the CLI equal the float32 runs bit for bit. A DeepLIIFKD
teacher runs at its own dir's precision.

The attention U-Net in train mode (float32; the JAX
``att_unet.apply(train=True)``: batch statistics over (B, H, W) in all
its norms, the attention gates' included; no dropout): one and two steps
of DeepLIIFExt with one modality and a ``unet_512_attention`` seg net
(256^2, batch 2, resnet_6blocks ngf 8, ndf 8) against JAX's jitted step:
every loss term within 1e-4 relative; the D gradients at JAX's fakes and
the G gradients against JAX's updated discriminators per tensor within
1e-3 of its max |g| plus twice each package's own float32 distance from
its float64 gradient (``att_grad_tols``: the net's batch norm over the
two values of its 1x1 innermost level amplifies rounding); a conv bias
that feeds a train-mode batch norm, whose gradient is 0 up to rounding,
held against its conv weight's max |g|; the parameters after one step
within 1e-6 wherever JAX's gradient exceeds that tolerance, within 2 lr
everywhere; step 2 from JAX's state read through its files within 2.12
lr. Each JAX function is compiled once for the file; the G loss's own
forward gives the D losses their fakes, and JAX's float64 gradients run in
a thread beside the rest (``torch_train_helpers.jax_g_grads_f64``)."""

import contextlib
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deepliif_tpu.models import deepliif as jdl, deepliif_ext as jext
from deepliif_tpu.utils import checkpoints as jck
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.models import (deepliif as dl, deepliif_ext as ext,
                                       deepliif_kd as kd)
from deepliif_tpu_torch.nets import layers as L
from deepliif_tpu_torch.nets import vgg as vgg_t
from deepliif_tpu_torch.utils import checkpoints as ck

import torch_train_helpers as H

KW = dict(H.TINY, use_dropout=False)
LOSS_TOL = 2e-2
BOUND_FACTOR = 3.0
# the attention case: DeepLIIFExt, one modality, an attention seg net
ATT_KW = dict(modalities_no=1, net_g=('resnet_6blocks',),
              net_gs=('unet_512_attention',), ngf=8, ndf=8,
              loss_g_weights=(1.0,), loss_d_weights=(1.0,),
              use_dropout=False)
ATT_SIZE = 256


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_def(**kw):
    return dl.DeepLIIFDef(**{**KW, 'dtype': torch.bfloat16, **kw})


def jax_def(**kw):
    return jdl.DeepLIIFDef(**{**KW, 'dtype': jnp.bfloat16, **kw})


@contextlib.contextmanager
def norm_eps(eps):
    """Every train-mode batch norm with ``eps`` (the faulty control)."""
    bn = L.train_batch_norm
    L.train_batch_norm = lambda x, scale, bias, _=None: bn(x, scale, bias,
                                                            eps)
    try:
        yield
    finally:
        L.train_batch_norm = bn


def port_grads(dtype, vnet, arrays, fault=contextlib.nullcontext()):
    """The port's D gradients at the initial weights and G gradients
    against the initial discriminators, in the JAX flat layout."""
    d = dl.DeepLIIFDef(**KW, dtype=dtype)
    nets_ = dl.init_nets(d, torch.Generator().manual_seed(0)).train()
    batch = H.torch_batch(arrays)
    groups = {name: [p for p in g.parameters()] for name, g in
              nets_.named_groups()}
    with fault:
        g_out = dl.train_forward(nets_, batch['A'], d)
        loss_d, _ = dl.d_loss_fn(nets_, g_out, batch, d)
        dl.set_grads(groups['D'] + groups['DS'], loss_d)
        loss_g, _ = dl.g_loss_fn(nets_, batch, d, vnet, g_out=g_out)
        dl.set_grads(groups['G'] + groups['GS'], loss_g)
    return {**H.grads_jax_layout(nets_, ('D', 'DS')),
            **H.grads_jax_layout(nets_, ('G', 'GS'))}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Step 1 and a step 2 from JAX's files in each package at bfloat16;
    the gradients of both packages at float32 and bfloat16 (and the
    port's with the faulty control)."""
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    d, jd = port_def(), jax_def()
    state = dl.create_train_state(d, opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    # copies: the jitted step donates its state
    gp, dp = jax.tree_util.tree_map(jnp.copy, (jstate.g_params,
                                               jstate.d_params))
    vnet = vgg_t.VGG19Features()
    vp = H.vgg_jax(vnet)
    out = {'port': [], 'jax': []}
    jstep = jdl.make_train_step(jd, g_tx, d_tx, vp)
    step = dl.make_train_step(d, vnet)
    arrays = H.batch_arrays(1, 2)
    jstate, jm, _ = jstep(jstate, H.jax_batch(arrays), jax.random.PRNGKey(0))
    state, metrics, _ = step(state, H.torch_batch(arrays))
    H.record(out, jstate, jm, state, metrics)
    out['shared_after_1'] = H.share_jax_state(
        str(tmp_path_factory.mktemp('jax_bf16')), jstate, state)
    a2 = H.batch_arrays(2, 2)
    jstate, jm, _ = jstep(jstate, H.jax_batch(a2), jax.random.PRNGKey(1))
    state, metrics, _ = step(state, H.torch_batch(a2))
    H.record(out, jstate, jm, state, metrics)

    jb = H.jax_batch(arrays)
    grads = {}
    for name, jdef in (('float32', jdl.DeepLIIFDef(**KW)), ('bfloat16', jd)):
        # the G loss's own forward gives the D loss its fakes
        (_, (_, fakes)), gg = jax.jit(
            jax.value_and_grad(jdl.g_loss_fn, has_aux=True),
            static_argnums=3)(gp, dp, jb, jdef, vp, jax.random.PRNGKey(0))
        _, dg = jax.jit(jax.value_and_grad(jdl.d_loss_fn, has_aux=True),
                        static_argnums=3)(dp, fakes, jb, jdef)
        grads[f'jax {name}'] = {**H.flat(dg), **H.flat(gg)}
    grads['port bfloat16'] = port_grads(torch.bfloat16, vnet, arrays)
    grads['port faulty'] = port_grads(torch.bfloat16, vnet, arrays,
                                      norm_eps(1e-3))
    out['grads'] = grads
    return out


@pytest.mark.parametrize('step', [0, 1])
def test_bf16_losses_match_jax(run, step):
    want = run['jax'][step]['metrics']
    got = run['port'][step]['metrics']
    assert sorted(got) == sorted(want)
    for k in want:
        assert H.rel(got[k], want[k]) <= LOSS_TOL, (k, got[k], want[k])


def test_bf16_second_step_from_jax_files(run):
    """JAX's bfloat16 state after step 1 read by the port (parameters
    equal, step and count 1); the parameters after step 2 within 2.12 lr
    of JAX's."""
    H.check_second_step(run)


def bound_ratios(grads, side):
    """{tensor: relative L2 distance of ``side``'s gradient from JAX's
    float32 one / JAX's bfloat16 distance from it}."""
    ref, jb = grads['jax float32'], grads['jax bfloat16']

    def dist(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-60))
    return {k: dist(grads[side][k], ref[k]) / max(dist(jb[k], ref[k]), 1e-30)
            for k in ref}


def test_bf16_gradients_within_the_accuracy_bound(run):
    ratios = bound_ratios(run['grads'], 'port bfloat16')
    assert sorted(ratios) == sorted(run['grads']['port faulty'])
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= BOUND_FACTOR, (worst, ratios[worst])


def test_bf16_bound_fails_the_faulty_control(run):
    ratios = bound_ratios(run['grads'], 'port faulty')
    assert max(ratios.values()) > BOUND_FACTOR


def test_bf16_nets_compute_in_bfloat16():
    """At bfloat16 the train-mode forward, the discriminators' patch maps
    and the VGG features of an output are bfloat16; the parameters, their
    gradients and the norm statistics float32."""
    d = port_def()
    nets_ = dl.init_nets(d, torch.Generator().manual_seed(0)).train()
    batch = H.torch_batch(H.batch_arrays(3, 2))
    seen = []
    stats = L.plane_mean_var_train

    def spy(x):
        st = stats(x)
        seen.append((x.dtype, st.dtype))
        return st
    L.plane_mean_var_train = spy
    try:
        g_out = dl.train_forward(nets_, batch['A'], d)
        pred = nets_.D[0](torch.cat([dl.nchw(batch['A']),
                                     dl.nchw(g_out['mods'][0])], 1))
    finally:
        L.plane_mean_var_train = stats
    assert g_out['mods'].dtype == g_out['seg'].dtype == torch.bfloat16
    assert pred.dtype == torch.bfloat16
    assert seen and set(seen) == {(torch.bfloat16, torch.float32)}
    feats = vgg_t.VGG19Features().features(dl.nchw(g_out['mods'][0]))
    assert all(f.dtype == torch.bfloat16 for f in feats)
    loss, _ = dl.g_loss_fn(nets_, batch, d, vgg_t.VGG19Features(),
                           g_out=g_out)
    assert loss.dtype == torch.float32
    params = list(nets_.G.parameters())
    grads = torch.autograd.grad(loss, params)
    assert all(p.dtype == g.dtype == torch.float32
               for p, g in zip(params, grads))


def _spectral_bf16_args():
    return ['--precision', 'bfloat16', '--norm', 'spectral', '--no-dropout',
            '--modalities-no', '1', '--batch-size', '2', '--seg-weights',
            '0.5,0.5', '--loss-weights-g', '0.5,0.5', '--loss-weights-d',
            '0.5,0.5']


def test_port_bf16_spectral_run_steps_in_jax(tmp_path):
    """A bfloat16 run of the port's ``train --norm spectral`` (one
    modality, resnet_2blocks, unet_32, one step) read by the JAX package's
    --continue-train readers, its optimizer state's u moments included,
    and stepped once by JAX's bfloat16 step; the port steps once from the
    same files."""
    H.write_rows(str(tmp_path / 'data' / 'train'), 3, count=2)
    run_dir = H.port_train(tmp_path / 'data', tmp_path / 'ckpt', 'bf16',
                           *_spectral_bf16_args())
    with np.load(os.path.join(run_dir, 'latest_optim.npz')) as f:
        u_moments = [k for k in f.files if k.endswith('/u')]
    assert u_moments and all(
        '.mu/' in k or '.nu/' in k for k in u_moments)
    kw = dict(modalities_no=1, net_g=('resnet_2blocks',),
              net_gs=('unet_32',) * 2, ngf=8, ndf=8, seg_weights=(0.5, 0.5),
              loss_g_weights=(0.5, 0.5), loss_d_weights=(0.5, 0.5),
              use_dropout=False, norm='spectral')
    d = dl.DeepLIIFDef(**kw, dtype=torch.bfloat16)
    jd = jdl.DeepLIIFDef(**kw, dtype=jnp.bfloat16)
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    state = dl.create_train_state(d, opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    params = jck.load_networks(run_dir, {**jstate.g_params,
                                         **jstate.d_params})
    before = H.flat(params)
    optim = jck.load_pytree(os.path.join(run_dir, 'latest_optim.npz'), {
        'g': jstate.g_opt_state, 'd': jstate.d_opt_state,
        'step': jstate.step})
    jstate = jdl.TrainState({k: params[k] for k in ('G', 'GS')},
                            {k: params[k] for k in ('D', 'DS')},
                            optim['g'], optim['d'], optim['step'])
    ck.load_networks(run_dir, state.nets)
    ck.load_optim(os.path.join(run_dir, 'latest_optim.npz'), state)
    vnet = vgg_t.VGG19Features()
    arrays = H.batch_arrays(4, 1)
    jstate, jm, _ = jdl.make_train_step(jd, g_tx, d_tx, H.vgg_jax(vnet))(
        jstate, H.jax_batch(arrays), jax.random.PRNGKey(3))
    state, metrics, _ = dl.make_train_step(d, vnet)(state,
                                                    H.torch_batch(arrays))
    out = {'jax': [None], 'port': [None], 'shared_after_1': (True, 1, 1)}
    H.record(out, jstate, jm, state, metrics)
    for k, want in out['jax'][1]['metrics'].items():
        assert H.rel(out['port'][1]['metrics'][k], want) <= LOSS_TOL, k
    H.check_second_step(out)
    H.check_refresh(before, {**out['jax'][1]['g'], **out['jax'][1]['d']},
                    kw)


def _family_rows(root, model):
    rng = np.random.default_rng(7)
    tiles = [rng.integers(0, 255, (64, 64, 3), np.uint8) for _ in range(3)]
    if model == 'CycleGAN':
        for sub, tile in (('trainA', tiles[0]), ('trainB1', tiles[1])):
            os.makedirs(os.path.join(root, sub))
            for i in range(2):
                Image.fromarray(np.roll(tile, i, 0)).save(
                    os.path.join(root, sub, f'{i}.png'))
        return
    os.makedirs(os.path.join(root, 'train'))
    for i in range(2):
        Image.fromarray(np.roll(np.concatenate(tiles, 1), i, 0)).save(
            os.path.join(root, 'train', f'r{i}.png'))


@pytest.mark.parametrize('model', ['DeepLIIFExt', 'SDG', 'CycleGAN'])
def test_other_families_train_float32_at_bf16(tmp_path, model):
    """``train --precision bfloat16`` of DeepLIIFExt, SDG and CycleGAN
    writes the float32 run's nets bit for bit (the JAX ``def_from_opt``
    of these families takes no dtype from ``precision``)."""
    from deepliif_tpu.models import cyclegan as jcg, deepliif_ext as jext
    from deepliif_tpu.models import sdg as jsdg
    from deepliif_tpu.config import Options as JOptions
    from deepliif_tpu.config import TRAIN_DEFAULTS as J_DEFAULTS
    jmod = {'DeepLIIFExt': jext, 'SDG': jsdg, 'CycleGAN': jcg}[model]
    assert jmod.def_from_opt(JOptions(d_params=dict(
        J_DEFAULTS, modalities_no=1, precision='bfloat16'))).dtype is None
    _family_rows(str(tmp_path / 'data'), model)
    nets = {}
    for precision in ('float32', 'bfloat16'):
        run_dir = H.port_train(tmp_path / 'data', tmp_path / 'ckpt',
                               precision, '--model', model,
                               '--modalities-no', '1', '--precision',
                               precision, '--batch-size', '2', '--no-flip',
                               '--serial-batches')
        nets[precision] = {}
        for f in sorted(os.listdir(run_dir)):
            if f.startswith('latest_net_'):
                with np.load(os.path.join(run_dir, f)) as z:
                    nets[precision].update({f'{f}/{k}': z[k]
                                            for k in z.files})
    assert nets['float32'] and nets['float32'].keys() == \
        nets['bfloat16'].keys()
    for k, v in nets['float32'].items():
        assert v.dtype == np.float32 and np.array_equal(
            v, nets['bfloat16'][k]), k


def test_kd_bf16_teacher_at_its_dirs_precision(tmp_path):
    """A bfloat16 DeepLIIF run as the DeepLIIFKD teacher loads at
    bfloat16 (its dir's precision, as the JAX ``load_teacher`` reads it),
    its outputs those of the bfloat16 session; a bfloat16 student trains
    one step against it through the CLI."""
    from deepliif_tpu_torch import models
    H.write_rows(str(tmp_path / 'data' / 'train'), 3, count=2)
    teacher = H.port_train(tmp_path / 'data', tmp_path / 'ckpt', 'teacher',
                           '--modalities-no', '1', '--precision',
                           'bfloat16')
    nets_, td = kd.load_teacher(teacher)
    assert td.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    mods, seg, segs = kd.teacher_forward(nets_, x, td)
    session = models.InferenceSession(teacher, device='cpu')
    assert session.d.dtype == torch.bfloat16
    with torch.no_grad():
        want = dl.generator_forward(session.nets, x, session.d)
    assert torch.equal(mods, want[0].float())
    assert torch.equal(seg, want[1].float())
    student = H.port_train(tmp_path / 'data', tmp_path / 'ckpt', 'student',
                           '--model', 'DeepLIIFKD', '--modalities-no', '1',
                           '--precision', 'bfloat16', '--model-dir-teacher',
                           teacher)
    assert H.optim_step(student) == 2


def att_arrays(seed):
    rng = np.random.default_rng(seed)
    shape = (H.BATCH, ATT_SIZE, ATT_SIZE, 3)
    return {'A': rng.uniform(-1, 1, shape).astype(np.float32),
            'B_mods': rng.uniform(-1, 1, (1,) + shape).astype(np.float32),
            'B_segs': rng.uniform(-1, 1, (1,) + shape).astype(np.float32)}


@pytest.fixture(scope='module')
def att(tmp_path_factory):
    """The attention case in each package: step 1 from the port's
    weights, the gradients (G against JAX's updated discriminators), step
    2 from JAX's state read through its files."""
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    d, jd = ext.DeepLIIFExtDef(**ATT_KW), jext.DeepLIIFExtDef(**ATT_KW)
    state = ext.create_train_state(d, opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    # copies: the jitted step donates its state
    gp, dp = jax.tree_util.tree_map(jnp.copy, (jstate.g_params,
                                               jstate.d_params))
    out = {'params0': (H.flat(gp), H.flat(dp)), 'port': [], 'jax': []}
    jstep = jext.make_train_step(jd, g_tx, d_tx)
    step = ext.make_train_step(d)
    a = att_arrays(1)
    jb = H.jax_batch(a)
    jstate, jm, _ = jstep(jstate, jb, jax.random.PRNGKey(0))
    state, metrics, _ = step(state, H.torch_batch(a))
    H.record(out, jstate, jm, state, metrics)
    out['port_d_grads_own'] = H.grads_jax_layout(state.nets, ('D', 'DS'))
    d1 = jax.tree_util.tree_map(jnp.copy, jstate.d_params)
    # JAX's G gradients in float64 (under x64, in a thread of their own
    # beside the rest; its norm statistics stay float32)
    f64_grads = H.jax_g_grads_f64(jext.g_loss_fn, (gp, d1, jb, jd),
                                  jax.random.PRNGKey(0))
    # the G loss's own forward (at the initial generators) gives the fakes
    (_, (_, fakes)), ggrads = jax.jit(
        jax.value_and_grad(jext.g_loss_fn, has_aux=True), static_argnums=3)(
            gp, d1, jb, jd, jax.random.PRNGKey(0))
    # the D gradients of the port at JAX's fakes: the attention U-Net's
    # batch norm over the two values of its 1x1 innermost level amplifies
    # rounding (the outputs of the two packages 1e-5 apart), and the
    # discriminators' leaky ReLUs turn that into percent of single
    # gradient elements
    fresh = ext.create_train_state(d, opt, 1, 0)
    dl.set_grads(fresh.d_params, ext.d_loss_fn(
        fresh.nets, {k: torch.from_numpy(np.array(v))
                     for k, v in fakes.items()}, H.torch_batch(a), d)[0])
    out['port_d_grads'] = H.grads_jax_layout(fresh.nets, ('D', 'DS'))
    _, dgrads = jax.jit(jax.value_and_grad(jext.d_loss_fn, has_aux=True),
                        static_argnums=3)(dp, fakes, jb, jd)
    out['jax_grads'] = (H.flat(dgrads), H.flat(ggrads))

    def g_grads(dtype):
        st = ext.create_train_state(d, opt, 1, 0)
        H.load_flat_groups(st.nets, out['jax'][0]['d'])
        st.nets.to(dtype)
        batch = {k: v.to(dtype) for k, v in H.torch_batch(a).items()}
        dl.set_grads(st.g_params, ext.g_loss_fn(st.nets, batch, d)[0])
        return H.grads_jax_layout(st.nets, ('G', 'GS'))
    out['port_grads_same_d'] = g_grads(torch.float32)
    out['port_grads_same_d_f64'] = g_grads(torch.float64)
    out['shared_after_1'] = H.share_jax_state(
        str(tmp_path_factory.mktemp('jax_att')), jstate, state)
    a = att_arrays(2)
    jstate, jm, _ = jstep(jstate, H.jax_batch(a), jax.random.PRNGKey(1))
    state, metrics, _ = step(state, H.torch_batch(a))
    H.record(out, jstate, jm, state, metrics)
    out['jax_g_grads_f64'] = f64_grads.result()
    return out


def _bias_scale(k, grads):
    """The scale a gradient tensor is held against: its max |g|, or, for
    the bias of an attention U-Net conv that feeds a train-mode batch norm
    (the middle encoder levels and the gates' three convs), its conv
    weight's."""
    name = k.rsplit('/', 2)
    if k.startswith('GS/') and k.endswith('/b') and (
            name[1].startswith('att') or name[1] in {
                f'conv{i}' for i in range(2, 8)}):
        return np.abs(grads[k[:-2] + '/w']).max()
    return np.abs(grads[k]).max()


@pytest.mark.parametrize('step', [0, 1])
def test_attention_losses_match_jax(att, step):
    H.check_losses(att, step)


def att_grad_tols(att):
    """{tensor: the gradient check's tolerance}: 1e-3 of its max |g|
    (``_bias_scale``), the G ones plus twice each package's own float32
    distance from its float64 gradient. The attention U-Net's batch norm
    over the two values of its 1x1 innermost level amplifies rounding: at
    these sizes both packages' float32 gradients lie up to 9 % of max |g|
    from float64 (the up convs), while the two float64 gradients agree to
    1.2e-3 (JAX keeps its statistics float32)."""
    jd, jg = att['jax_grads']
    tols = {k: 1e-3 * _bias_scale(k, jd) for k in jd}
    f32, f64 = att['port_grads_same_d'], att['port_grads_same_d_f64']
    j64 = att['jax_g_grads_f64']
    tols.update({k: 1e-3 * _bias_scale(k, jg)
                 + 2 * np.abs(f32[k] - f64[k]).max()
                 + 2 * np.abs(jg[k] - j64[k]).max() for k in jg})
    return tols


def test_attention_gradients_match_jax(att):
    """D at JAX's fakes, G against JAX's updated discriminators."""
    tols = att_grad_tols(att)
    for got, want in ((att['port_d_grads'], att['jax_grads'][0]),
                      (att['port_grads_same_d'], att['jax_grads'][1])):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= tols[k], k


def test_attention_parameters_after_one_step(att):
    """Within 1e-6 wherever JAX's gradient exceeds the gradient check's
    tolerance (Adam's first update is lr sign(g), and below it the two
    packages' signs may differ), within 2 lr everywhere; every tensor
    moved. The step's D gradients are taken at each package's own fakes,
    so a D tensor's tolerance adds twice the port's distance between its D
    gradients at its own and at JAX's fakes."""
    grads = {**att['jax_grads'][0], **att['jax_grads'][1]}
    tols = att_grad_tols(att)
    own, at_jax = att['port_d_grads_own'], att['port_d_grads']
    tols.update({k: tols[k] + 2 * np.abs(own[k] - at_jax[k]).max()
                 for k in own})
    for i, part in enumerate(('g', 'd')):
        want, got = att['jax'][0][part], att['port'][0][part]
        for k in want:
            diff = np.abs(got[k] - want[k])
            assert diff[np.abs(grads[k]) > tols[k]].max(initial=0) <= 1e-6, k
            assert diff.max() <= 2 * H.LR * (1 + 1e-3), k
            assert np.abs(got[k] - att['params0'][i][k]).max() > 0, k


def test_attention_second_step_from_jax_files(att):
    H.check_losses(att, 1)
    H.check_second_step(att)
