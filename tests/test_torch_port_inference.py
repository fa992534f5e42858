"""The port's tiled inference engine against the JAX engine, end to end, on
a tiny DeepLIIF model dir written by the JAX package (CPU).

Tolerance: uint8 outputs may differ by 1 LSB on fewer than 0.1% of pixels,
because the truncating float -> uint8 cast flips where the two frameworks'
float32 results straddle an integer."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import jax

from deepliif_tpu import models as M_jax
from deepliif_tpu.models import deepliif as dl_jax
from deepliif_tpu.utils import checkpoints as ck_jax
from deepliif_tpu_torch import models as M
from conftest import cpu_subprocess_env
from test_inference import TINY_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    md = tmp_path_factory.mktemp('tiny_port_model')
    d = dl_jax.DeepLIIFDef(
        modalities_no=2, net_g=('resnet_6blocks',) * 2, net_gs=('unet_32',) * 3,
        ngf=8, ndf=8, seg_weights=(0.4, 0.3, 0.3))
    params = dl_jax.init_params(jax.random.PRNGKey(7), d,
                                with_discriminators=False)
    ck_jax.save_networks(str(md), params)
    with open(md / 'config.json', 'w') as f:
        json.dump(TINY_CFG, f)
    return str(md)


@pytest.fixture(scope='module')
def session(model_dir):
    return M.InferenceSession(model_dir, device='cpu')


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


def test_run_tiles_matches_jax(model_dir, session):
    tiles = np.random.default_rng(5).integers(0, 255, (3, 64, 64, 3), np.uint8)
    ref = M_jax.InferenceSession(model_dir, n_devices=1).run_tiles(tiles)
    got = session.run_tiles(tiles)
    assert set(got) == set(ref) == {'G1', 'G2', 'GS'}
    for k in ref:
        assert got[k].dtype == np.uint8
        _assert_u8_close(got[k], ref[k])


def test_inference_matches_jax(model_dir, session):
    img = _img(150, 100)
    ref = M_jax.inference(img, tile_size=64, overlap_size=4,
                          model_path=model_dir)
    got = M.inference(img, tile_size=64, overlap_size=4, model_path=model_dir,
                      session=session)
    assert set(got) == set(ref) == {'mod1-ModA', 'mod2-ModB', 'Seg'}
    for k in ref:
        assert got[k].size == ref[k].size == img.size
        _assert_u8_close(got[k], ref[k])


def test_infer_modalities_matches_jax(model_dir):
    img = _img(128, 128, seed=1)
    ref_images, ref_scoring = M_jax.infer_modalities(img, 64, model_dir)
    images, scoring = M.infer_modalities(img, 64, model_dir, device='cpu')
    assert set(images) == set(ref_images)
    assert set(scoring) == set(ref_scoring)
    for k in ref_images:
        _assert_u8_close(images[k], ref_images[k])


def test_batch_size_invariance(session):
    """Outputs do not depend on how tiles are bucketed into batches: the
    norm statistics are per sample, as in the reference."""
    tiles = np.random.default_rng(5).integers(0, 255, (3, 64, 64, 3), np.uint8)
    batched = session.run_tiles(tiles)
    for i in range(3):
        single = session.run_tiles(tiles[i:i + 1])
        for k in batched:
            np.testing.assert_array_equal(batched[k][i], single[k][0])


def test_run_to_run_consistency(model_dir, session):
    img = _img(90, 70)
    r1 = M.inference(img, tile_size=64, overlap_size=4, model_path=model_dir,
                     session=session)
    r2 = M.inference(img, tile_size=64, overlap_size=4, model_path=model_dir,
                     session=session)
    for k in r1:
        np.testing.assert_array_equal(np.asarray(r1[k]), np.asarray(r2[k]))


def test_empty_tile_short_circuit(model_dir, session, monkeypatch):
    """A uniform image returns background tiles without running the nets."""
    def no_forward(*a, **k):
        raise AssertionError('forward ran on an empty tile')
    monkeypatch.setattr(session, 'forward', no_forward)
    img = Image.fromarray(np.full((64, 64, 3), 230, np.uint8))
    images = M.inference(img, tile_size=64, overlap_size=0,
                         model_path=model_dir, session=session)
    assert (np.asarray(images['mod1-ModA'])
            == np.asarray((201, 211, 208), np.uint8)).all()
    assert (np.asarray(images['Seg']) == 0).all()


def test_unported_options_raise(model_dir, session):
    """The options that raised before they were ported, seg-only and the
    seg intermediates, now run and match the JAX engine (the names of
    their outputs and the values within the uint8 tolerance); the full
    checks are in tests/test_torch_port_seg_only.py."""
    tiles = np.random.default_rng(5).integers(0, 255, (2, 64, 64, 3),
                                              np.uint8)
    jax_session = M_jax.InferenceSession(model_dir, n_devices=1)
    for kw in ({'seg_only': True}, {'return_intermediate': True}):
        ref, got = jax_session.run_tiles(tiles, **kw), session.run_tiles(
            tiles, **kw)
        assert set(got) == set(ref)
        for k in ref:
            _assert_u8_close(got[k], ref[k])


def test_cli_writes_same_files_as_jax_cli(model_dir, tmp_path):
    inp = tmp_path / 'in'
    inp.mkdir()
    _img(128, 96, seed=2).save(inp / 'sample.png')
    outs = {}
    for mod, extra in (('deepliif_tpu.cli', []),
                       ('deepliif_tpu_torch.cli', ['--device', 'cpu'])):
        out = tmp_path / mod
        res = subprocess.run(
            [sys.executable, '-m', mod, 'test', '--input-dir', str(inp),
             '--output-dir', str(out), '--tile-size', '64', '--model-dir',
             model_dir, *extra],
            capture_output=True, text=True, cwd=REPO, timeout=300,
            env=cpu_subprocess_env())
        assert res.returncode == 0, res.stderr[-2000:]
        outs[mod] = out
    names = sorted(os.listdir(outs['deepliif_tpu.cli']))
    assert names == sorted(os.listdir(outs['deepliif_tpu_torch.cli']))
    with open(outs['deepliif_tpu.cli'] / 'sample.json') as f:
        ref_scoring = json.load(f)
    with open(outs['deepliif_tpu_torch.cli'] / 'sample.json') as f:
        assert set(json.load(f)) == set(ref_scoring)
