"""The port's generators against the JAX nets on the same weights, the
reference state-dict layout, and the weight bridge round trip.

Tolerance: 1e-4 absolute on the tanh outputs, the repo's f32 layer
tolerance (tests/test_layers_torch_parity.py)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu.models import deepliif as dl_jax
from deepliif_tpu.nets import resnet as resnet_jax, unet as unet_jax
from deepliif_tpu.utils import checkpoints as ck_jax
from deepliif_tpu_torch import nets
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.utils import checkpoints as ck
from test_torch_import import _rand_init, torch_resnet_g, torch_unet_g

TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _port_forward(net, x_nhwc):
    with torch.no_grad():
        y = net.eval()(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('padding', ['zero', 'reflect'])
def test_resnet_matches_jax(padding):
    p = resnet_jax.init(jax.random.PRNGKey(3), 3, 3, ngf=8, n_blocks=2,
                        padding_type=padding)
    x = _x((2, 64, 64, 3))
    ref = resnet_jax.apply(p, jnp.asarray(x), n_blocks=2, norm='batch',
                           use_dropout=True, padding_type=padding)
    net = nets.define_g(3, 3, 8, 'resnet_2blocks', padding_type=padding)
    net.load_state_dict(ck.params_from_jax(net, _np_tree(p)), strict=True)
    assert np.abs(_port_forward(net, x) - np.asarray(ref)).max() < TOL


@pytest.mark.parametrize('arch,num_downs,size',
                         [('unet_32', 5, 32), ('unet_64', 6, 64)])
def test_unet_matches_jax(arch, num_downs, size):
    p = unet_jax.init(jax.random.PRNGKey(4), 3, 3, num_downs, ngf=8)
    x = _x((2, size, size, 3), seed=1)
    ref = unet_jax.apply(p, jnp.asarray(x), num_downs=num_downs, norm='batch',
                         use_dropout=True)
    net = nets.define_g(3, 3, 8, arch)
    net.load_state_dict(ck.params_from_jax(net, _np_tree(p)), strict=True)
    assert np.abs(_port_forward(net, x) - np.asarray(ref)).max() < TOL


@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_resnet_reference_layout_loads_strict(padding):
    ref = _rand_init(torch_resnet_g(3, 3, ngf=16, n_blocks=2,
                                    padding_type=padding))
    net = nets.define_g(3, 3, 16, 'resnet_2blocks', padding_type=padding)
    assert list(net.state_dict()) == list(ref.state_dict())
    net.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = ref(x)
        got = net.eval()(x)
    assert (got - want).abs().max().item() < 1e-3  # test_torch_import's bound


@pytest.mark.parametrize('num_downs', [5, 6])
def test_unet_reference_layout_loads_strict(num_downs):
    ref = _rand_init(torch_unet_g(3, 3, num_downs))
    net = nets.define_g(3, 3, 8, f'unet_{2 ** num_downs}')
    assert list(net.state_dict()) == list(ref.state_dict())
    net.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(1, 3, 2 ** num_downs, 2 ** num_downs,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = ref(x)
        got = net.eval()(x)
    assert (got - want).abs().max().item() < 1e-3


def test_reference_checkpoint_files_load(tmp_path):
    """A reference .pth with BatchNorm running stats and a 'module.' prefix
    loads with strict=True (the stats are dropped)."""
    import torch.nn as nn
    ref = nets.define_g(3, 3, 8, 'resnet_2blocks', padding_type='zero')
    sd = {f'module.{k}': v for k, v in ref.state_dict().items()}
    for k in [k for k in sd if k.endswith('.bias') and 'conv_block.1' in k]:
        base = k[:-len('.bias')]
        sd[f'{base}.running_mean'] = torch.zeros(32)
        sd[f'{base}.running_var'] = torch.ones(32)
        sd[f'{base}.num_batches_tracked'] = torch.tensor(0)
    torch.save(sd, tmp_path / 'latest_net_G1.pth')
    net = nets.define_g(3, 3, 8, 'resnet_2blocks', padding_type='zero')
    ck.load_reference_state_dict(net, str(tmp_path / 'latest_net_G1.pth'))
    for k, v in ref.state_dict().items():
        assert torch.equal(net.state_dict()[k], v)
    assert isinstance(net.model[2], nn.BatchNorm2d)


def test_weight_round_trip_is_byte_equal(tmp_path):
    """JAX tree -> npz -> port modules -> params_to_jax -> same npz bytes."""
    d_jax = dl_jax.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                               net_gs=('unet_32',) * 3, ngf=8, ndf=8,
                               seg_weights=(0.4, 0.3, 0.3))
    params = dl_jax.init_params(jax.random.PRNGKey(7), d_jax,
                                with_discriminators=False)
    ck_jax.save_networks(str(tmp_path), params)
    d = dl.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                       net_gs=('unet_32',) * 3, ngf=8,
                       seg_weights=(0.4, 0.3, 0.3))
    ens = dl.DeepLIIFNets(d)
    for group, mods in (('G', ens.G), ('GS', ens.GS)):
        path = os.path.join(str(tmp_path), f'latest_net_{group}.npz')
        ck.load_group_npz(path, mods)
        per_net = [ck.flatten_tree(ck.params_to_jax(n)) for n in mods]
        back = {k: np.stack([f[k] for f in per_net]) for k in per_net[0]}
        with np.load(path) as data:
            assert list(back) == list(data.files)
            for k in data.files:
                assert back[k].dtype == data[k].dtype
                assert back[k].shape == data[k].shape
                assert back[k].tobytes() == data[k].tobytes(), k


def test_define_g_rejects_unported_arch():
    """An architecture the JAX package does not know raises as there; the
    attention U-Net, which raised until it was ported, builds in the
    reference layout (its forward against JAX:
    tests/test_torch_port_norms.py)."""
    for arch in ('resnet_xblocks', 'vgg_16'):
        with pytest.raises(NotImplementedError, match='not recognized'):
            nets.define_g(3, 3, 8, arch)
    net = nets.define_g(3, 3, 8, 'unet_512_attention')
    assert isinstance(net, nets.AttUnetGenerator)
    assert 'Att2.psi.0.weight' in net.state_dict()
