"""The port's host commands against the JAX package's on the same inputs
(CPU): ``eval`` on a tiny DeepLIIF dir (the real_A images, the gallery
and the file names byte-equal; the fake_B images within 1 LSB on fewer
than 0.1 % of pixels, the f32 image limit of the engine tests),
``prepare-training-data``, ``prepare-testing-data``, ``register`` and
``visualize`` (every file written byte-equal, the printed transform
equal), and the port's copies of ``utils.augmentation`` and
``utils.registration`` against the JAX functions, mirroring
tests/test_offline_tools.py."""

import json
import os
import pickle
import shutil
import time

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from deepliif_tpu import cli as cli_jax
from deepliif_tpu.models import deepliif as dl_jax
from deepliif_tpu.utils import augmentation as aug_jax
from deepliif_tpu.utils import registration as reg_jax
from deepliif_tpu_torch import cli
from deepliif_tpu_torch.utils import augmentation as aug, registration as reg
from test_inference import TINY_CFG
from test_torch_port_families import _init, _write


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _invoke(group, args):
    res = CliRunner().invoke(group, args, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return res.output


def _both(args_for):
    """Run a command of each CLI with ``args_for(tag)``; returns the two
    outputs (JAX, port)."""
    return (_invoke(cli_jax.cli, args_for('jax')),
            _invoke(cli.make_cli(), args_for('port')))


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    d = dl_jax.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                           net_gs=('unet_32',) * 3, ngf=8, ndf=8,
                           seg_weights=(0.4, 0.3, 0.3))
    return _write(str(tmp_path_factory.mktemp('eval_model')),
                  _init(dl_jax.init_params, d, 7), dict(TINY_CFG))


def test_eval_matches_jax(model_dir, tmp_path):
    rows = tmp_path / 'ds' / 'test'
    rows.mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i in range(4):                 # A | B1 | B2 | B_seg, 64 px tiles
        Image.fromarray(rng.integers(0, 255, (64, 256, 3), np.uint8)).save(
            rows / f'row{i}.png')
    _both(lambda tag: ['eval', '--dataroot', str(tmp_path / 'ds'),
                       '--model-dir', model_dir, '--output-dir',
                       str(tmp_path / tag), '--num-test', '3',
                       '--seg-weights', '0.5,0.25,0.25']
          + (['--device', 'cpu'] if tag == 'port' else []))
    ref, got = _files(tmp_path / 'jax'), _files(tmp_path / 'port')
    assert sorted(got) == sorted(ref)
    assert len([k for k in got if k.endswith('.png')]) == 3 * 4
    assert got['index.html'] == ref['index.html']
    for k in ref:
        if 'real_A' in k:
            assert got[k] == ref[k], k
        elif k.endswith('.png'):
            a = np.asarray(Image.open(tmp_path / 'port' / k), np.int16)
            b = np.asarray(Image.open(tmp_path / 'jax' / k), np.int16)
            diff = np.abs(a - b)
            assert a.shape == b.shape and diff.max() <= 1, k
            assert (diff > 0).mean() < 1e-3, k


@pytest.fixture
def stains(tmp_path):
    src = tmp_path / 'stains'
    src.mkdir()
    rng = np.random.default_rng(2)
    for name in ('a', 'b', 'c'):
        for stain in ('IHC', 'Hematoxylin', 'DAPI', 'Lap2', 'Marker', 'Seg'):
            Image.fromarray(rng.integers(0, 255, (48, 40, 3), np.uint8)).save(
                src / f'{name}_{stain}.png')
    return src


def test_prepare_training_data_matches_jax(stains, tmp_path):
    out = _both(lambda tag: ['prepare-training-data', '--input-dir',
                             str(stains), '--output-dir', str(tmp_path / tag),
                             '--validation-ratio', '0.5', '--seed', '3'])
    assert out[0] == out[1]
    ref = _files(tmp_path / 'jax')
    assert len(ref) == 3 and ref == _files(tmp_path / 'port')


def test_prepare_testing_data_matches_jax(stains, tmp_path):
    out = _both(lambda tag: ['prepare-testing-data', '--input-dir',
                             str(stains), '--dataset-dir',
                             str(tmp_path / tag)])
    assert out[0] == out[1]
    ref = _files(tmp_path / 'jax')
    assert len(ref) == 3 and ref == _files(tmp_path / 'port')


@pytest.mark.parametrize('manual', [[], ['--translate', '5,-7'],
                                    ['--scale', '1.1', '--rotate', '7']])
def test_register_matches_jax(tmp_path, manual):
    rng = np.random.default_rng(11)
    base = rng.integers(0, 255, (96, 96, 3), np.uint8)
    Image.fromarray(base).save(tmp_path / 'fixed.png')
    Image.fromarray(np.roll(base, (7, -5), axis=(0, 1))).save(
        tmp_path / 'moving.png')
    out = _both(lambda tag: ['register', '--fixed', str(tmp_path / 'fixed.png'),
                             '--moving', str(tmp_path / 'moving.png'),
                             '--output', str(tmp_path / tag / 'al.png')]
                + manual)
    ref, got = (json.loads(o.strip().splitlines()[-1]) for o in out)
    assert got == ref
    if not manual:
        assert (got['dx'], got['dy']) == (5, -7)
    assert _files(tmp_path / 'port') == _files(tmp_path / 'jax')


def test_visualize_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    src = tmp_path / 'src'
    src.mkdir()
    with open(src / 'plot_current_losses.pickle', 'wb') as f:
        pickle.dump({'x': 1.5, 'losses': {'G_GAN': 0.7, 'D_real': 0.25}}, f)
    with open(src / 'display_current_results.pickle', 'wb') as f:
        pickle.dump({'epoch': 3, 'visuals': {
            'real_A': rng.integers(0, 255, (16, 16, 3), np.uint8),
            'fake_B_1': rng.integers(0, 255, (16, 16, 3), np.uint8)}}, f)
    for tag in ('jax', 'port'):
        shutil.copytree(src, tmp_path / tag)

    def interrupt(seconds):            # one polling pass, then ctrl-c
        raise KeyboardInterrupt
    monkeypatch.setattr(time, 'sleep', interrupt)
    out = _both(lambda tag: ['visualize', '--pickle-dir',
                             str(tmp_path / tag)])
    assert out[0].replace(str(tmp_path / 'jax'),
                          str(tmp_path / 'port')) == out[1]
    got = _files(tmp_path / 'port')
    assert {'live_losses.json', os.path.join('web', 'index.html'),
            os.path.join('web', 'images', 'epoch003_real_A.png')} <= set(got)
    assert got == _files(tmp_path / 'jax')


def test_replay_display_snapshot_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    disp = {'epoch': 3,
            'visuals': {'real_A': rng.integers(0, 255, (16, 16, 3), np.uint8),
                        'fake_B_1': rng.integers(0, 255, (16, 16, 3),
                                                 np.uint8)}}
    cli_jax.replay_display_snapshot(str(tmp_path / 'jax'), disp)
    cli.replay_display_snapshot(str(tmp_path / 'port'), disp)
    assert (tmp_path / 'port' / 'web' / 'images' /
            'epoch003_real_A.png').exists()
    assert _files(tmp_path / 'port') == _files(tmp_path / 'jax')


# -- the copied host modules, as tests/test_offline_tools.py checks them ----

def test_augmentation_matches_jax():
    rng = np.random.default_rng(0)
    imgs = {i: rng.integers(0, 255, (96, 96, 3), np.uint8) for i in range(3)}
    got = aug.Augmentation(dict(imgs), tile_size=96,
                           rng=np.random.RandomState(1)).pipeline()
    want = aug_jax.Augmentation(dict(imgs), tile_size=96,
                                rng=np.random.RandomState(1)).pipeline()
    assert set(got) == set(want) == set(imgs)
    for k in want:
        assert got[k].shape == (96, 96, 3)
        np.testing.assert_array_equal(got[k], want[k])


def test_stain_deconvolution_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (16, 16, 3), np.uint8)
    img[:8] = (120, 80, 40)
    for a, b in zip(aug.stain_deconvolution(img),
                    aug_jax.stain_deconvolution(img)):
        np.testing.assert_array_equal(a, b)
    assert aug.stain_deconvolution(img[:8])[2].mean() > 0


def test_dataset_builder_and_augment_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    src = tmp_path / 'src'
    src.mkdir()
    for stain in ('IHC', 'DAPI', 'Hema', 'Lap2', 'Marker', 'Seg'):
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), np.uint8)).save(
            src / f'a_{stain}.png')
    for tag, m in (('jax', aug_jax), ('port', aug)):
        n = m.create_training_dataset_from_stains(
            str(src), str(tmp_path / tag / 'ds'), tile_size=48,
            subsets={'train': 1.0})
        assert n == 1
        na = m.augment_dataset(str(tmp_path / tag / 'ds' / 'train'),
                               str(tmp_path / tag / 'aug'), aug_no=2)
        assert na == 2
    got = _files(tmp_path / 'port')
    assert len(got) == 4 and got == _files(tmp_path / 'jax')


def test_registration_matches_jax():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (96, 96, 3), np.uint8)
    moved = np.roll(np.roll(base, 5, axis=0), -9, axis=1)
    got = reg.register_translation(base, moved)
    assert got == reg_jax.register_translation(base, moved)
    assert got[:2] == (9, -5) and got[2] > 0.9
    (a, info), (b, info_j) = (reg.register_pair(base, moved),
                              reg_jax.register_pair(base, moved))
    assert info == info_j and a.size == (96, 96)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    img = Image.fromarray(np.full((10, 10, 3), 200, np.uint8))
    for kw in ({'translate': (3, 2)}, {'scale': 1.3, 'rotate_deg': 20}):
        out = np.asarray(reg.apply_affine(img, output_size=(10, 10), **kw))
        np.testing.assert_array_equal(out, np.asarray(reg_jax.apply_affine(
            img, output_size=(10, 10), **kw)))
    out = np.asarray(reg.apply_affine(img, translate=(3, 2),
                                      output_size=(10, 10)))
    assert (out[:2] == 0).all() and (out[2:, 3:] == 200).all()
