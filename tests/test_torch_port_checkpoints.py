"""Native ``.npz`` model groups in both layouts the JAX package writes, and
replicate padding against the JAX ResNet.

A uniform group (every translator, or every seg net, of one architecture)
stacks each leaf along a leading net axis; a group of mixed architectures
is a list of per-net trees with npz keys ``0/...``, ``1/...``
(deepliif_tpu/models/deepliif.py init_params). Both load strictly into
``DeepLIIFNets``, and the port's float32 forward then matches the JAX
forward on the same seeded input within 1e-4 absolute, the repo's f32
layer tolerance (tests/test_layers_torch_parity.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepliif_tpu.models import deepliif as dl_jax
from deepliif_tpu.utils import checkpoints as ck_jax
from deepliif_tpu_torch import nets
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.nets import layers
from deepliif_tpu_torch.utils import checkpoints as ck

TOL = 1e-4
ARCHS = {
    'uniform': (('resnet_2blocks',) * 2, ('unet_32',) * 3),
    'mixed': (('resnet_2blocks', 'unet_32'),
              ('unet_32', 'resnet_2blocks', 'unet_32')),
}


@pytest.mark.parametrize('layout', sorted(ARCHS))
def test_native_group_loads_and_matches_jax_forward(tmp_path, layout):
    """Save a 2-modality model with JAX ``save_networks``, load both groups
    into the port, and compare the modalities and the seg at float32."""
    net_g, net_gs = ARCHS[layout]
    kw = dict(modalities_no=2, net_g=net_g, net_gs=net_gs, ngf=8,
              seg_weights=(0.4, 0.3, 0.3))
    d_jax = dl_jax.DeepLIIFDef(ndf=8, **kw)
    params = dl_jax.init_params(jax.random.PRNGKey(11), d_jax,
                                with_discriminators=False)
    assert isinstance(params['G'], list) == (layout == 'mixed')
    ck_jax.save_networks(str(tmp_path), params)
    with np.load(os.path.join(str(tmp_path), 'latest_net_G.npz')) as z:
        heads = {k.split('/', 1)[0] for k in z.files}
    assert (heads == {'0', '1'}) == (layout == 'mixed')

    d = dl.DeepLIIFDef(**kw)
    ens = dl.DeepLIIFNets(d)
    ck.load_group_npz(os.path.join(str(tmp_path), 'latest_net_G.npz'), ens.G)
    ck.load_group_npz(os.path.join(str(tmp_path), 'latest_net_GS.npz'),
                      ens.GS)

    x = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    ref = dl_jax.inference_forward(params, jnp.asarray(x), d_jax)
    with torch.no_grad():
        got = dl.inference_forward(ens.eval(), torch.from_numpy(x), d)
    for k in ('mods', 'seg'):
        assert got[k].shape == ref[k].shape, k
        err = np.abs(got[k].numpy() - np.asarray(ref[k])).max()
        assert err < TOL, (k, err)


def test_group_trees_rejects_a_group_of_the_wrong_size():
    flat = {'0/a/w': np.zeros(4), '1/a/w': np.zeros(4)}
    assert len(ck.group_trees(flat, 2)) == 2
    with pytest.raises(ValueError, match='stacked nets'):
        ck.group_trees(flat, 3)


@pytest.mark.parametrize('call', [
    lambda: nets.ResnetGenerator(3, 3, 8, n_blocks=2,
                                 padding_type='replicate'),
    lambda: layers.pad2d(torch.zeros(1, 3, 8, 8), 1, 'replicate'),
], ids=['ResnetGenerator', 'pad2d'])
def test_replicate_padding_names_its_roadmap_item(call):
    """Replicate padding, which raised under its ROADMAP item until it was
    ported, now runs: the generator pads its trunk convs in the reflect
    layout (a pad module, then an unpadded conv) and matches the JAX
    ResNet on the same weights; the pad equals ``jnp.pad`` mode 'edge'."""
    from deepliif_tpu.nets import layers as L_jax, resnet as resnet_jax
    out = call()
    x = np.random.default_rng(4).uniform(-1, 1, (2, 3, 16, 16)).astype(
        np.float32)
    if isinstance(out, torch.Tensor):
        x = np.random.default_rng(4).uniform(-1, 1, (1, 8, 8, 3)).astype(
            np.float32)
        got = layers.pad2d(torch.from_numpy(x).permute(0, 3, 1, 2), 1,
                           'replicate').permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(L_jax.pad2d(jnp.asarray(x), 1, 'replicate')))
        return
    block = out.blocks[0].conv_block
    assert isinstance(block[0], torch.nn.ReplicationPad2d)
    assert block[1].padding == (0, 0)
    tree = ck.params_to_jax(out)
    ref = resnet_jax.apply(tree, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           n_blocks=2, norm='batch', use_dropout=True,
                           padding_type='replicate')
    with torch.no_grad():
        got = out.eval()(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - np.asarray(ref)).max() < TOL
