"""The port's ``serialize`` (``cli.run_serialize`` and
``utils.checkpoints.save_networks``) against the JAX package's (CPU), for
DeepLIIF, DeepLIIFExt, SDG and CycleGAN: from a native dir and from a
reference dir of torch state dicts, the port writes npz files with the keys
and the bit-equal float32 arrays of JAX ``checkpoints.save_networks`` of the
JAX session's params; a JAX session loads the port's output and agrees with
the port within 1 LSB on fewer than 0.1 % of pixels; the command's parity
gate (sum |diff| <= 10) runs in-process and fails on altered weights."""

import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from deepliif_tpu import models as M_jax
from deepliif_tpu.models import cyclegan as cg_jax
from deepliif_tpu.models import deepliif as dl_jax
from deepliif_tpu.models import deepliif_ext as ext_jax
from deepliif_tpu.models import sdg as sdg_jax
from deepliif_tpu.utils import checkpoints as ck_jax
from deepliif_tpu_torch import cli, models as M
from deepliif_tpu_torch.utils import checkpoints as ck
from test_inference import TINY_CFG
from test_torch_port_families import (BASE, _assert_u8_close, _ext_cfg,
                                      _init, _reference_dir, _write)

# 'mixed': a DeepLIIF dir whose translators differ (its G group is a list
# of per-net trees, keyed '0/...', '1/...')
FAMILIES = ('deepliif', 'mixed', 'ext', 'sdg', 'cyclegan')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers (torch's per-op
    pool oversubscribes the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deepliif_reference_dir(native, out):
    """A DeepLIIF native dir as reference files: latest_net_G{i}.pth and
    latest_net_GS{i}.pth (the reference's net names)."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(native, 'config.json')) as f:
        cfg = f.read()
    with open(os.path.join(out, 'config.json'), 'w') as f:
        f.write(cfg)
    sess = M.InferenceSession(native, device='cpu')
    for i, net in enumerate(sess.nets.G):
        torch.save(net.state_dict(), os.path.join(out, f'latest_net_G{i + 1}.pth'))
    for i, net in enumerate(sess.nets.GS):
        torch.save(net.state_dict(), os.path.join(out, f'latest_net_GS{i}.pth'))
    return out


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    """{family: (native dir, reference dir, channels of a tile)}."""
    root = str(tmp_path_factory.mktemp('serialize'))
    out = {}
    d = dl_jax.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                           net_gs=('unet_32',) * 3, ngf=8, ndf=8,
                           seg_weights=(0.4, 0.3, 0.3))
    native = _write(os.path.join(root, 'deepliif'),
                    _init(dl_jax.init_params, d, 11), TINY_CFG)
    out['deepliif'] = (native, _deepliif_reference_dir(
        native, os.path.join(root, 'deepliif_ref')), 3)
    net_g = ('resnet_2blocks', 'resnet_6blocks')
    d = dl_jax.DeepLIIFDef(modalities_no=2, net_g=net_g,
                           net_gs=('unet_32',) * 3, ngf=8, ndf=8,
                           seg_weights=(0.4, 0.3, 0.3))
    native = _write(os.path.join(root, 'mixed'),
                    _init(dl_jax.init_params, d, 15),
                    dict(TINY_CFG, netG=list(net_g)))
    out['mixed'] = (native, _deepliif_reference_dir(
        native, os.path.join(root, 'mixed_ref')), 3)
    d = ext_jax.DeepLIIFExtDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                               net_gs=('unet_32',) * 2, ngf=8, ndf=8,
                               loss_g_weights=(0.5, 0.5),
                               loss_d_weights=(0.5, 0.5))
    native = _write(os.path.join(root, 'ext'),
                    _init(ext_jax.init_params, d, 12), _ext_cfg())
    out['ext'] = (native, _reference_dir(native, os.path.join(root,
                                                              'ext_ref')), 3)
    d = sdg_jax.SDGDef(modalities_no=2, input_no=2,
                       net_g=('resnet_6blocks',) * 2, ngf=8,
                       loss_g_weights=(0.5, 0.5), loss_d_weights=(0.5, 0.5))
    native = _write(os.path.join(root, 'sdg'), _init(sdg_jax.init_params, d, 13),
                    dict(BASE, model='SDG', modalities_no=2, input_no=2,
                         modalities_names=['in1', 'in2', 'm1', 'm2']))
    out['sdg'] = (native, _reference_dir(native, os.path.join(root,
                                                              'sdg_ref')), 6)
    d = cg_jax.CycleGANDef(modalities_no=1, net_g=('resnet_6blocks',), ngf=8,
                           loss_g_weights=(1.0,), loss_d_weights=(1.0,))
    native = _write(os.path.join(root, 'cyclegan'),
                    _init(cg_jax.init_params, d, 14),
                    dict(BASE, model='CycleGAN', modalities_no=1,
                         modalities_names=['m0', 'm1']))
    out['cyclegan'] = (native, _reference_dir(
        native, os.path.join(root, 'cyclegan_ref')), 3)
    return out


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _assert_same_npz_dirs(got_dir, want_dir):
    got = sorted(f for f in os.listdir(got_dir) if f.endswith('.npz'))
    want = sorted(f for f in os.listdir(want_dir) if f.endswith('.npz'))
    assert got == want and want
    for fn in want:
        a, b = _npz(os.path.join(got_dir, fn)), _npz(os.path.join(want_dir, fn))
        assert sorted(a) == sorted(b), fn
        for k in b:
            assert a[k].dtype == b[k].dtype == np.float32, (fn, k)
            assert a[k].shape == b[k].shape, (fn, k)
            assert np.array_equal(a[k], b[k]), (fn, k)


@pytest.mark.parametrize('family', FAMILIES)
@pytest.mark.parametrize('layout', ('native', 'reference'))
def test_serialized_npz_bit_equal_to_jax(dirs, tmp_path, family, layout):
    src = dirs[family][0 if layout == 'native' else 1]
    port_out, jax_out = str(tmp_path / 'port'), str(tmp_path / 'jax')
    cli.run_serialize(src, port_out, do_verify=False, device='cpu',
                      echo=lambda *_: None)
    ck_jax.save_networks(jax_out, M_jax.InferenceSession(
        src, n_devices=1).params)
    _assert_same_npz_dirs(port_out, jax_out)
    if family == 'mixed':
        assert '0/down0_conv/w' in _npz(os.path.join(port_out,
                                                  'latest_net_G.npz'))
    assert os.path.exists(os.path.join(port_out, 'config.json'))
    assert not [f for f in os.listdir(port_out) if '.tmp-' in f]


@pytest.mark.parametrize('family', FAMILIES)
def test_jax_session_loads_the_port_output(dirs, tmp_path, family):
    src, ref, nc = dirs[family]
    out = str(tmp_path / 'out')
    cli.run_serialize(ref, out, do_verify=False, device='cpu',
                      echo=lambda *_: None)
    tiles = np.random.default_rng(3).integers(0, 255, (2, 64, 64, nc),
                                              np.uint8)
    want = M.InferenceSession(src, device='cpu').run_tiles(tiles)
    got = M_jax.InferenceSession(out, n_devices=1).run_tiles(tiles)
    assert set(got) == set(want)
    for k in want:
        _assert_u8_close(got[k], want[k])


def test_cli_parity_gate_in_process(dirs, tmp_path):
    src = dirs['deepliif'][1]
    out = str(tmp_path / 'out')
    res = CliRunner().invoke(cli.make_cli(), [
        'serialize', '--model-dir', src, '--output-dir', out, '--device',
        'cpu', '--verbose', '--tile-size', '64'])
    assert res.exit_code == 0, res.output
    assert 'parity check passed (sum|diff| = 0.0 <= 10)' in res.output
    assert 'serialized net G' in res.output and 'serialized net GS' in res.output
    assert M.InferenceSession(out, device='cpu').run_tiles(
        np.zeros((1, 64, 64, 3), np.uint8))


def test_parity_gate_fails_on_altered_weights(dirs, tmp_path, monkeypatch):
    """The gate compares the written dir with the source: weights altered
    on the way out fail it."""
    save = ck.save_networks

    def altered(save_dir, nets, epoch='latest'):
        with torch.no_grad():
            nets.G[0].model[1].weight.add_(0.5)
        save(save_dir, nets, epoch)
        with torch.no_grad():
            nets.G[0].model[1].weight.sub_(0.5)

    monkeypatch.setattr(ck, 'save_networks', altered)
    with pytest.raises(AssertionError, match='parity failed'):
        cli.run_serialize(dirs['deepliif'][0], str(tmp_path / 'out'),
                          tile_size=64, device='cpu', echo=lambda *_: None)


def test_numbered_epoch_refreshes_latest(dirs, tmp_path):
    sess = M.InferenceSession(dirs['cyclegan'][0], device='cpu')
    ck.save_networks(str(tmp_path), sess.nets, epoch=7)
    files = sorted(os.listdir(tmp_path))
    assert files == ['7_net_GA.npz', '7_net_GB.npz', 'latest_net_GA.npz',
                     'latest_net_GB.npz']
    for g in ('GA', 'GB'):
        a, b = (_npz(str(tmp_path / f'{ep}_net_{g}.npz'))
                for ep in (7, 'latest'))
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)
