"""Seg-only and seg-intermediate outputs of the port against the JAX
package, on tiny DeepLIIF model dirs written by the JAX package (its param
trees, numpy-seeded values at the reference init; CPU).

The dir has three modalities named Hema, DAPI and Marker, and seg weights
(0.5, 0, 0.5, 0): seg-only runs the DAPI translator (its seg branch has a
weight) and the Marker translator (the marker output), and the seg nets of
the input and of DAPI; a spy on the nets checks which ran.

Tolerance: uint8 outputs within 1 LSB on fewer than 0.1 % of pixels (the
truncating float32 -> uint8 cast flips where the two frameworks' float32
results straddle an integer); the port's seg-only seg and marker are
byte-equal to its own full forward's."""

import json
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from deepliif_tpu import cli as cli_jax, models as M_jax
from deepliif_tpu.models import deepliif as dl_jax
from deepliif_tpu.utils import checkpoints as ck_jax
from deepliif_tpu_torch import cli, models as M
from test_torch_port_families import _init

NAMES = ['IHC', 'Hema', 'DAPI', 'Marker']
WEIGHTS = (0.5, 0.0, 0.5, 0.0)
CFG = {'model': 'DeepLIIF', 'modalities_no': 3, 'seg_gen': True,
       'seg_no': 1, 'input_no': 1, 'netG': 'resnet_2blocks',
       'net_gs': 'unet_32', 'ngf': 8, 'norm': 'batch', 'no_dropout': False,
       'padding': 'zero', 'scale_size': 64, 'seg_weights': list(WEIGHTS),
       'modalities_names': NAMES}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers (torch's per-op
    pool oversubscribes the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_dir(md, net_g, net_gs, seed):
    d = dl_jax.DeepLIIFDef(modalities_no=3, net_g=net_g, net_gs=net_gs,
                           ngf=8, ndf=8, seg_weights=WEIGHTS)
    ck_jax.save_networks(str(md), _init(dl_jax.init_params, d, seed))
    cfg = dict(CFG, netG=list(net_g), net_gs=list(net_gs))
    with open(os.path.join(str(md), 'config.json'), 'w') as f:
        json.dump(cfg, f)
    return str(md)


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    return _write_dir(tmp_path_factory.mktemp('seg_only'),
                      ('resnet_2blocks',) * 3, ('unet_32',) * 4, 21)


@pytest.fixture(scope='module')
def session(model_dir):
    return M.InferenceSession(model_dir, device='cpu')


@pytest.fixture(scope='module')
def jax_session(model_dir):
    return M_jax.InferenceSession(model_dir, n_devices=1)


def _tiles(n=3, seed=5):
    return np.random.default_rng(seed).integers(0, 255, (n, 64, 64, 3),
                                                np.uint8)


def _img(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


def _assert_u8_close(a, b):
    a = np.asarray(a).astype(np.int16)
    b = np.asarray(b).astype(np.int16)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


class _Spy:
    """Records which nets of the ensemble ran a forward."""

    def __init__(self, session, monkeypatch):
        self.ran = []
        for group in ('G', 'GS'):
            for i, net in enumerate(getattr(session.nets, group)):
                monkeypatch.setattr(net, 'forward', self._wrap(
                    f'{group}{i}', net.forward))

    def _wrap(self, name, fn):
        def forward(x):
            self.ran.append(name)
            return fn(x)
        return forward


def test_seg_only_runs_the_weighted_branches_and_the_marker(session,
                                                             monkeypatch):
    spy = _Spy(session, monkeypatch)
    out = session.run_tiles(_tiles(), seg_only=True)
    assert sorted(spy.ran) == ['G1', 'G2', 'GS0', 'GS2']
    spy.ran.clear()
    session.run_tiles(_tiles())
    assert sorted(spy.ran) == ['G0', 'G1', 'G2', 'GS0', 'GS1', 'GS2', 'GS3']
    # the modalities seg-only skips keep their background colors
    assert (out['G1'] == np.asarray((201, 211, 208), np.uint8)).all()
    assert (out['G2'] == np.asarray((10, 10, 10), np.uint8)).all()


@pytest.mark.parametrize('weights', [None, (0.25, 0.25, 0.25, 0.25)],
                         ids=['config', 'uniform'])
def test_seg_only_is_byte_equal_to_the_full_forward(session, weights):
    tiles = _tiles()
    full = session.run_tiles(tiles, seg_weights=weights)
    seg_only = session.run_tiles(tiles, seg_weights=weights, seg_only=True)
    assert set(seg_only) == set(full) == {'G1', 'G2', 'G3', 'GS'}
    np.testing.assert_array_equal(seg_only['GS'], full['GS'])
    np.testing.assert_array_equal(seg_only['G3'], full['G3'])


def test_seg_only_run_tiles_matches_jax(session, jax_session):
    tiles = _tiles()
    ref = jax_session.run_tiles(tiles, seg_only=True)
    got = session.run_tiles(tiles, seg_only=True)
    assert set(got) == set(ref)
    for k in ref:
        _assert_u8_close(got[k], ref[k])


def test_seg_intermediate_run_tiles_matches_jax(session, jax_session):
    tiles = _tiles()
    ref = jax_session.run_tiles(tiles, return_intermediate=True)
    got = session.run_tiles(tiles, return_intermediate=True)
    assert set(got) == set(ref) == {'G1', 'G2', 'G3', 'GS', 'GS0', 'GS1',
                                    'GS2', 'GS3'}
    for k in ref:
        _assert_u8_close(got[k], ref[k])
    full = session.run_tiles(tiles)
    for k in full:
        np.testing.assert_array_equal(got[k], full[k])


@pytest.mark.parametrize('flag', ['seg_only', 'return_seg_intermediate'])
def test_infer_modalities_names_and_scoring_match_jax(model_dir, flag):
    img = _img(128, 96, seed=1)
    ref_images, ref_scoring = M_jax.infer_modalities(img, 64, model_dir,
                                                     **{flag: True})
    images, scoring = M.infer_modalities(img, 64, model_dir, device='cpu',
                                         **{flag: True})
    assert set(images) == set(ref_images)
    if flag == 'seg_only':
        # the marker is scored, then dropped with the other non-Seg images
        assert set(images) == {'Seg', 'SegOverlaid', 'SegRefined'}
    else:
        assert {f'mod{i}-{nm}_s' for i, nm in enumerate(NAMES)} <= set(images)
    for k in ref_images:
        _assert_u8_close(images[k], ref_images[k])
    assert scoring == ref_scoring


def test_seg_only_on_the_device_stitch(model_dir):
    """seg-only through the device stitch and quantifier (on the CPU)
    equals the host path."""
    img = _img(128, 128, seed=3)
    host = M.infer_modalities(img, 64, model_dir, device='cpu', seg_only=True)
    dev = M.infer_modalities(img, 64, model_dir, device='cpu', seg_only=True,
                             device_quant=True)
    assert set(host[0]) == set(dev[0]) and host[1] == dev[1]
    for k in host[0]:
        np.testing.assert_array_equal(np.asarray(host[0][k]),
                                      np.asarray(dev[0][k]))


def test_mixed_architectures_take_the_full_forward(tmp_path):
    """A dir whose nets do not share one architecture runs the full forward
    for seg-only, and leaves the intermediates at their zero fill, as the
    JAX package does."""
    md = _write_dir(tmp_path, ('resnet_2blocks', 'unet_32', 'resnet_2blocks'),
                    ('unet_32',) * 4, 22)
    tiles = _tiles(2, seed=6)
    ref_sess = M_jax.InferenceSession(md, n_devices=1)
    sess = M.InferenceSession(md, device='cpu')
    for kw in ({'seg_only': True}, {'return_intermediate': True}):
        ref, got = ref_sess.run_tiles(tiles, **kw), sess.run_tiles(tiles,
                                                                   **kw)
        assert set(got) == set(ref)
        for k in ref:
            _assert_u8_close(got[k], ref[k])
    assert not sess.run_tiles(tiles, return_intermediate=True)['GS1'].any()


@pytest.mark.parametrize('flag', ['--seg-only', '--seg-intermediate'])
def test_cli_writes_same_files_as_jax_cli(model_dir, tmp_path, flag):
    inp = tmp_path / 'in'
    inp.mkdir()
    _img(128, 96, seed=2).save(inp / 'sample.png')
    outs = {}
    for name, command, extra in (
            ('jax', cli_jax.cli, []),
            ('port', cli.make_cli(), ['--device', 'cpu'])):
        out = tmp_path / name
        res = CliRunner().invoke(command, [
            'test', '--input-dir', str(inp), '--output-dir', str(out),
            '--tile-size', '64', '--model-dir', model_dir, flag, *extra])
        assert res.exit_code == 0, res.output[-2000:]
        outs[name] = out
    names = sorted(os.listdir(outs['jax']))
    assert names == sorted(os.listdir(outs['port']))
    for fn in names:
        if fn.endswith('.png'):
            _assert_u8_close(Image.open(outs['port'] / fn),
                             Image.open(outs['jax'] / fn))
    with open(outs['jax'] / 'sample.json') as f, \
            open(outs['port'] / 'sample.json') as g:
        assert json.load(g) == json.load(f)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
def test_cuda_seg_only_byte_equal_and_fewer_launches(cuda, model_dir):
    """On the card: seg-only's seg and marker equal the full forward's, run
    to run, with the trunk kernel launched for the two translators it runs
    (2 blocks x 2 convs each) and the statistics kernel for its nets."""
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.ops import fused_resblock as FR
    sess = M.InferenceSession(model_dir, device='cuda')
    tiles = _tiles()
    full = sess.run_tiles(tiles)
    sess.run_tiles(tiles, seg_only=True)   # the bucket's probe runs here
    counts = []
    for _ in range(2):
        t0, p0 = FR.conv3x3_stats.launches, L.plane_mean_var.launches
        got = sess.run_tiles(tiles, seg_only=True)
        counts.append((FR.conv3x3_stats.launches - t0,
                       L.plane_mean_var.launches - p0))
        np.testing.assert_array_equal(got['GS'], full['GS'])
        np.testing.assert_array_equal(got['G3'], full['G3'])
    # one batch forward: 2 translators x 4 trunk convs; norms: 5 per
    # translator, 7 per unet_32, 2 seg nets
    assert counts == [(2 * 4, 2 * 5 + 2 * 7)] * 2
