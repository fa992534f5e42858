"""The norms, paddings and upsamplers beyond the flagship's (instance,
none and spectral norms; replicate padding; resize_conv and pixel_shuffle
up stages) and the attention U-Net, against the JAX package (CPU): each
layer, each variant of a tiny ResNet and U-Net on JAX weights, the
reference state-dict layout as the JAX importer reads it, a spectral-norm
DeepLIIF session, and the attention U-Net at one 256^2 sample.

Tolerances: float32 layers and nets within 1e-4 absolute (the repo's f32
layer tolerance, tests/test_layers_torch_parity.py); the attention U-Net
within 2e-3 (tests/test_torch_import.py, its depth of 15 norms); uint8
session outputs within 1 LSB on fewer than 0.1 % of pixels."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepliif_tpu import models as M_jax
from deepliif_tpu.nets import att_unet as att_jax, layers as L_jax
from deepliif_tpu.nets import resnet as resnet_jax, unet as unet_jax
from deepliif_tpu.utils import torch_import as ti
from deepliif_tpu_torch import models as M, nets, roadmap
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.nets import layers as L
from deepliif_tpu_torch.nets import resnet as resnet_port
from deepliif_tpu_torch.ops import fused_resblock as FR
from deepliif_tpu_torch.utils import checkpoints as ck
from test_torch_import import _rand_init, torch_att_unet

TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers (torch's per-op
    pool oversubscribes the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(net, seed):
    """Seeded numpy weights for every parameter and buffer of ``net``: conv
    weights N(0, 0.1), norm scales N(1, 0.1), biases N(0, 0.1),
    power-iteration vectors N(0, 1); returns the JAX param tree."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith('spectral_u'):
            a = rng.normal(0, 1, v.shape)
        elif k.endswith('weight') and v.dim() == 1:
            a = rng.normal(1, 0.1, v.shape)
        else:
            a = rng.normal(0, 0.1, v.shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    net.load_state_dict(sd, strict=True)
    return ck.params_to_jax(net)


# -- layers -----------------------------------------------------------------

def test_instance_norm_matches_jax():
    x = _x((2, 9, 11, 6)) * 3 + 1
    ref = np.asarray(L_jax.instance_norm(jnp.asarray(x)))
    assert np.abs(_nhwc(L.instance_norm(_nchw(x))) - ref).max() < TOL
    assert L.apply_norm(_nchw(x), 'none', None) is not None
    np.testing.assert_array_equal(_nhwc(L.apply_norm(_nchw(x), 'spectral',
                                                     None)), x)


@pytest.mark.parametrize('mode', ['zero', 'reflect', 'replicate'])
def test_pad2d_matches_jax(mode):
    x = _x((2, 5, 7, 3))
    ref = np.asarray(L_jax.pad2d(jnp.asarray(x), 2, mode))
    np.testing.assert_array_equal(_nhwc(L.pad2d(_nchw(x), 2, mode)), ref)


@pytest.mark.parametrize('op', ['upsample_nearest', 'pixel_shuffle'])
def test_upsamplers_match_jax(op):
    x = _x((2, 5, 7, 12))
    ref = np.asarray(getattr(L_jax, op)(jnp.asarray(x), 2))
    np.testing.assert_array_equal(_nhwc(getattr(L, op)(_nchw(x), 2)), ref)


@pytest.mark.parametrize('kind', ['conv', 'convT'])
def test_spectral_sigma_matches_jax(kind):
    rng = np.random.default_rng(3)
    w_hwio = rng.normal(0, 0.1, (3, 3, 6, 5)).astype(np.float32)
    u = rng.normal(0, 1, 3 * 3 * 6).astype(np.float32)
    ref_w, ref_u = L_jax._sn_single(jnp.asarray(w_hwio), jnp.asarray(u), 3)
    w_t = ck.weight_from_hwio(torch.from_numpy(w_hwio), kind).contiguous()
    sigma = L.spectral_sigma(ck.weight_to_hwio(w_t, kind), torch.from_numpy(u))
    got = ck.weight_to_hwio(w_t / sigma, kind).numpy()
    assert np.abs(got - np.asarray(ref_w)).max() < 1e-6


# -- tiny nets on JAX weights -------------------------------------------------

RESNET_VARIANTS = [
    ('instance', 'zero', 'convtranspose'),
    ('instance', 'reflect', 'convtranspose'),
    ('none', 'zero', 'convtranspose'),
    ('batch', 'replicate', 'convtranspose'),
    ('instance', 'replicate', 'convtranspose'),
    ('batch', 'zero', 'resize_conv'),
    ('instance', 'reflect', 'resize_conv'),
    ('batch', 'zero', 'pixel_shuffle'),
    ('none', 'replicate', 'pixel_shuffle'),
]


@pytest.mark.parametrize('variant', RESNET_VARIANTS,
                         ids=['-'.join(v) for v in RESNET_VARIANTS])
def test_resnet_variant_matches_jax(variant):
    norm, padding, upsample = variant
    kw = dict(n_blocks=2, norm=norm, use_dropout=True, padding_type=padding,
              upsample=upsample)
    net = nets.define_g(3, 3, 8, 'resnet_2blocks', norm, True, padding,
                        upsample)
    p = _randomize(net, 5)
    x = _x((2, 32, 32, 3), seed=1)
    ref = np.asarray(jax.jit(lambda p, x: resnet_jax.apply(p, x, **kw))(
        p, jnp.asarray(x)))
    # the JAX init's tree has the port's keys
    like = jax.eval_shape(lambda k: resnet_jax.init(k, 3, 3, ngf=8, **kw),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert ck.flatten_tree(p).keys() == ck.flatten_tree(like).keys()
    net.load_state_dict(ck.params_from_jax(net, p), strict=True)
    with torch.no_grad():
        got = _nhwc(net.eval()(_nchw(x)))
    assert np.abs(got - ref).max() < TOL
    # the port's layout is the reference's as the JAX importer reads it
    imported = ti.import_resnet_g(net.state_dict(), **kw)
    assert ck.flatten_tree(imported).keys() == ck.flatten_tree(
        ck.params_to_jax(net)).keys()
    for k, v in ck.flatten_tree(imported).items():
        np.testing.assert_array_equal(v, ck.flatten_tree(p)[k])


@pytest.mark.parametrize('norm', ['instance', 'none'])
def test_unet_norm_matches_jax(norm):
    net = nets.define_g(3, 3, 8, 'unet_32', norm)
    p = _randomize(net, 6)
    x = _x((2, 32, 32, 3), seed=2)
    ref = np.asarray(jax.jit(lambda p, x: unet_jax.apply(
        p, x, num_downs=5, norm=norm, use_dropout=True))(p, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(net.eval()(_nchw(x)))
    assert np.abs(got - ref).max() < TOL
    imported = ti.import_unet_g(net.state_dict(), 5, norm, True)
    like = jax.eval_shape(lambda k: unet_jax.init(k, 3, 3, 5, ngf=8,
                                                  norm=norm),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert ck.flatten_tree(imported).keys() == ck.flatten_tree(p).keys() \
        == ck.flatten_tree(like).keys()


def test_trunk_kernel_gate_follows_the_jax_rule(monkeypatch):
    """The trunk runs the kernel path (``resblock_chain``) only with batch
    norm and reflect or zero padding, as the JAX ``_fused_ok`` admits."""
    calls = []
    real = FR.resblock_chain
    monkeypatch.setattr(FR, 'resblock_chain',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(_x((1, 3, 32, 32)))
    for (norm, padding), want in ((('batch', 'zero'), 1),
                                  (('batch', 'reflect'), 1),
                                  (('batch', 'replicate'), 0),
                                  (('instance', 'zero'), 0),
                                  (('none', 'reflect'), 0)):
        calls.clear()
        with torch.no_grad():
            nets.define_g(3, 3, 8, 'resnet_2blocks', norm, True,
                          padding).eval()(x)
        assert len(calls) == want, (norm, padding)
    with pytest.raises(ValueError, match='fuse_stages'):
        resnet_port.fused_stages_gate(torch.bfloat16, variant=(
            'instance', 'zero', 'convtranspose'))
    with pytest.raises(ValueError, match='fuse_stages'):
        resnet_port.fused_stages_gate(torch.bfloat16, variant=(
            'batch', 'zero', 'resize_conv'))


def test_instance_norm_bf16_runs_the_unfused_trunk():
    """A bfloat16 instance-norm ResNet (conv biases in the trunk) runs and
    stays near its float32 self."""
    net = nets.define_g(3, 3, 8, 'resnet_2blocks', 'instance', True,
                        'replicate', 'pixel_shuffle').eval()
    x = torch.from_numpy(_x((1, 3, 32, 32), seed=4))
    with torch.no_grad():
        want = net(x)
        net.compute_dtype = torch.bfloat16
        got = net(x)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() < 0.1


# -- spectral norm, DeepLIIF session ------------------------------------------

def write_spectral_dir(md):
    """A tiny spectral-norm DeepLIIF dir (1 resnet_2blocks translator, 2
    unet_32 seg nets, ngf 8) with numpy-seeded weights and power-iteration
    vectors, in the native layout."""
    ens = dl.DeepLIIFNets(dl.DeepLIIFDef(
        modalities_no=1, net_g=('resnet_2blocks',), net_gs=('unet_32',) * 2,
        ngf=8, norm='spectral', seg_weights=(0.5, 0.5)))
    for seed, (group, mods) in enumerate(ens.named_groups()):
        flat = [ck.flatten_tree(_randomize(n, 9 + 2 * seed + i))
                for i, n in enumerate(mods)]
        np.savez(os.path.join(md, f'latest_net_{group}.npz'),
                 **{k: np.stack([f[k] for f in flat]) for k in flat[0]})
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump({'model': 'DeepLIIF', 'modalities_no': 1, 'seg_gen': True,
                   'seg_no': 1, 'netG': 'resnet_2blocks', 'net_gs': 'unet_32',
                   'ngf': 8, 'norm': 'spectral', 'padding': 'zero',
                   'scale_size': 64, 'seg_weights': [0.5, 0.5],
                   'modalities_names': ['IHC', 'Marker']}, f)
    return md


@pytest.fixture(scope='module')
def spectral_dir(tmp_path_factory):
    return write_spectral_dir(str(tmp_path_factory.mktemp('spectral')))


def test_spectral_session_matches_jax(spectral_dir):
    tiles = np.random.default_rng(10).integers(0, 255, (2, 64, 64, 3),
                                               np.uint8)
    ref = M_jax.InferenceSession(spectral_dir, n_devices=1).run_tiles(tiles)
    sess = M.InferenceSession(spectral_dir, device='cpu')
    got = sess.run_tiles(tiles)
    assert set(got) == set(ref)
    for k in ref:
        d = np.abs(got[k].astype(np.int16) - ref[k].astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    # the power-iteration vectors round-trip with the weights
    with np.load(os.path.join(spectral_dir, 'latest_net_G.npz')) as z:
        flat = ck.flatten_tree(ck.params_to_jax(sess.nets.G[0]))
        assert any(k.endswith('/u') for k in flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(v, z[k][0])


# -- the attention U-Net --------------------------------------------------------

@pytest.fixture(scope='module')
def att_case():
    """A reference-layout AttU_Net, its JAX import and output at one 256^2
    sample (jitted once)."""
    ref = _rand_init(torch_att_unet())
    x = _x((1, 256, 256, 3), seed=11)
    params = ti._as_jnp(ti.import_att_unet(ref.state_dict()))
    out = jax.jit(att_jax.apply)(params, jnp.asarray(x))
    return ref, _np_tree(params), x, np.asarray(out)


def test_att_unet_reference_layout_matches_jax(att_case):
    ref, params, x, want = att_case
    net = nets.define_g(3, 3, 64, 'unet_512_attention')
    assert list(net.state_dict()) == list(ref.state_dict())
    net.load_state_dict(ref.state_dict(), strict=True)
    with torch.no_grad():
        got = _nhwc(net.eval()(_nchw(x)))
    assert np.abs(got - want).max() < 2e-3
    # the weight bridge: the JAX tree into the module and back
    net2 = nets.define_g(3, 3, 8, 'unet_512_attention')
    net2.load_state_dict(ck.params_from_jax(net2, params), strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(net2.state_dict()[k], v), k
    back = ck.flatten_tree(ck.params_to_jax(net2))
    for k, v in ck.flatten_tree(params).items():
        np.testing.assert_array_equal(back[k], v)


def test_att_unet_seg_session_runs_bf16(tmp_path):
    """A DeepLIIF dir with attention seg nets runs through the engine at
    float32 and bfloat16; the bf16 seg stays near the float32 one (int8:
    tests/test_torch_port_int8_variants.py, and on the card)."""
    md = str(tmp_path)
    d = dl.DeepLIIFDef(modalities_no=1, net_g=('resnet_2blocks',),
                       net_gs=('unet_512_attention',) * 2, ngf=8,
                       seg_weights=(0.5, 0.5))
    ens = dl.DeepLIIFNets(d)
    torch.manual_seed(0)
    for group, mods in ens.named_groups():
        for net in mods:
            for mod in net.modules():
                if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                    torch.nn.init.normal_(mod.weight, 0, 0.02)
        flat = [ck.flatten_tree(ck.params_to_jax(n)) for n in mods]
        np.savez(os.path.join(md, f'latest_net_{group}.npz'),
                 **{k: np.stack([f[k] for f in flat]) for k in flat[0]})
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump({'model': 'DeepLIIF', 'modalities_no': 1, 'seg_gen': True,
                   'seg_no': 1, 'netG': 'resnet_2blocks',
                   'net_gs': 'unet_512_attention', 'ngf': 8,
                   'padding': 'zero', 'scale_size': 256,
                   'seg_weights': [0.5, 0.5],
                   'modalities_names': ['IHC', 'Marker']}, f)
    tiles = np.random.default_rng(12).integers(0, 255, (1, 256, 256, 3),
                                               np.uint8)
    f32 = M.InferenceSession(md, device='cpu').run_tiles(tiles)
    got = M.InferenceSession(md, device='cpu',
                             precision='bfloat16').run_tiles(tiles)
    assert set(f32) == set(got) == {'G1', 'GS'}
    d = np.abs(f32['GS'].astype(np.int16) - got['GS'].astype(np.int16))
    assert d.mean() < 2.0

