"""The bfloat16 and int8 (ResNet-trunk scope) slice of the port against the
JAX engine, end to end on the CPU: ``run_tiles`` and ``infer_modalities``
on 128^2 tiles (two 16-row chunks in the trunk) with a model dir of ngf 32,
resnet_2blocks translators and unet_32 seg nets; int8 with per-chunk
dynamic scales and with static scales from a synthetic act_scales.json;
then, on 64^2 tiles, batch-size invariance, run-to-run equality and the
CLI options. The int8 sessions against JAX are in
test_torch_port_int8_slice.py (a file of their own, so that test workers
run the two halves side by side).

The JAX side runs its fused trunk kernels in interpret mode
(``DEEPLIIF_FUSED=1``, ``DEEPLIIF_INT8_SCOPE=resblocks``), eagerly
(``jax.disable_jit()``): eagerly, every bf16 op rounds its result to bf16,
the semantics the port implements. Jitted on the CPU, XLA folds some bf16
conversions away (a norm then takes its statistics from the unrounded
float32 conv output), which moves the outputs further from both.

Tolerances, on uint8 outputs against the JAX session:
- bfloat16: mean |d| <= 0.5 LSB and >= 99 % of pixels within 2 LSB (bf16
  rounds the tanh outputs to 8 significant bits, about 0.5 LSB near +-1,
  and a conv summed in another order rounds a bf16 value one ulp apart on
  about 0.1 % of its outputs). Measured: 0.12-0.39 LSB, >= 99.93 %.
- int8 trunk, one translator given the same bf16 trunk input as JAX
  (its trunk and tail): the same bound. Measured: 0.0002 LSB.
- int8 sessions: the same bound, on IHC-like tiles (a light background
  with hematoxylin-blue and DAB-brown nuclei, the input the system is
  for). Measured: <= 0.25 LSB, >= 99.7 % within 2 LSB. On tiles of
  uniform noise the int8 trunk amplifies the head's bf16 rounding
  differences (one ulp on 0.08 % of the trunk input can move a chunk's
  max, and so the dynamic scale of every value of that chunk, or flip a
  static quantization step) past 0.5 LSB mean, on the same model where
  the trunk alone agrees to 0.0002 LSB."""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

import jax

from deepliif_tpu import models as M_jax
from deepliif_tpu_torch import cli, models as M
from test_torch_port_precision import _act_scales, write_model_dir

CASES = [('bfloat16', False), ('int8', False), ('int8', True)]
IDS = ['bfloat16', 'int8_dynamic', 'int8_static']


@pytest.fixture(scope='module')
def model_dirs(tmp_path_factory):
    md = write_model_dir(tmp_path_factory.mktemp('port_slice_model'))
    static = str(tmp_path_factory.mktemp('port_slice_static'))
    for fn in os.listdir(md):
        shutil.copy(os.path.join(md, fn), static)
    with open(os.path.join(static, 'act_scales.json'), 'w') as f:
        json.dump({'scales': _act_scales()}, f)
    return {False: md, True: static}


@pytest.fixture
def jax_fused(monkeypatch):
    monkeypatch.setenv('DEEPLIIF_FUSED', '1')
    monkeypatch.setenv('DEEPLIIF_INT8_SCOPE', 'resblocks')
    monkeypatch.setenv('DEEPLIIF_INFER_DEVICES', '1')


def _scope(precision):
    return 'resblocks' if precision == 'int8' else None


# (max mean |d| in LSB, min share of pixels within 2 LSB)
TOL = {'bfloat16': (0.5, 0.99), 'int8': (0.5, 0.99), 'trunk': (0.5, 0.99)}


def _assert_u8_close(a, b, tol):
    a = np.asarray(a).astype(np.int16)
    b = np.asarray(b).astype(np.int16)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.mean() <= TOL[tol][0], d.mean()
    assert (d <= 2).mean() >= TOL[tol][1], (d <= 2).mean()


def _tiles(n, size, seed=5):
    return np.random.default_rng(seed).integers(0, 255, (n, size, size, 3),
                                                np.uint8)


def ihc_like_image(h, w, seed=0):
    """Light background with hematoxylin-blue and DAB-brown nuclei."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.float32)
    img[:] = (222, 216, 210)
    img += rng.normal(0, 6, img.shape)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(h * w // 1500):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(4, 9) ** 2
        color = (95, 85, 160) if rng.random() < 0.6 else (150, 95, 55)
        img[m] = color + rng.normal(0, 8, (m.sum(), 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _inputs(precision):
    """Two 128^2 tiles and a 128x200 image: uniform noise for bf16,
    IHC-like for int8 (see the module docstring)."""
    if precision == 'int8':
        big = ihc_like_image(256, 256)
        return (np.stack([big[:128, :128], big[128:, 128:]]),
                ihc_like_image(128, 200, seed=1))
    return _tiles(2, 128), np.random.default_rng(1).integers(
        0, 255, (128, 200, 3), np.uint8)


def run_tiles_vs_jax(md, precision, static=False):
    tiles = _inputs(precision)[0]
    with jax.disable_jit():
        ref = M_jax.InferenceSession(md, n_devices=1,
                                     precision=precision).run_tiles(tiles)
    sess = M.InferenceSession(md, device='cpu', precision=precision,
                              int8_scope=_scope(precision))
    if precision == 'int8':
        assert sess.nets.G[0].int8_mode == ('static' if static else 'dynamic')
    got = sess.run_tiles(tiles)
    assert set(got) == set(ref) == {'G1', 'G2', 'GS'}
    for k in ref:
        assert got[k].dtype == np.uint8
        _assert_u8_close(got[k], ref[k], precision)


def infer_modalities_vs_jax(md, precision):
    # two 128^2 tiles, the batch shape of run_tiles_vs_jax (the eager JAX
    # ops compile once per shape)
    img = Image.fromarray(_inputs(precision)[1])
    with jax.disable_jit():
        ref_images, ref_scoring = M_jax.infer_modalities(img, 128, md,
                                                         precision=precision)
    images, scoring = M.infer_modalities(img, 128, md, device='cpu',
                                         precision=precision,
                                         int8_scope=_scope(precision))
    assert set(images) == set(ref_images)
    assert set(scoring) == set(ref_scoring)
    for k in ref_images:
        _assert_u8_close(images[k], ref_images[k], precision)


def test_bf16_run_tiles_matches_jax(model_dirs, jax_fused):
    run_tiles_vs_jax(model_dirs[False], 'bfloat16')


def test_bf16_infer_modalities_matches_jax(model_dirs, jax_fused):
    infer_modalities_vs_jax(model_dirs[False], 'bfloat16')


@pytest.mark.parametrize('precision,static', CASES, ids=IDS)
def test_batch_size_invariance_and_run_to_run(model_dirs, precision, static):
    """Outputs do not depend on how tiles are bucketed (norm statistics and
    dynamic int8 scales are per sample), and two runs are byte-equal."""
    sess = M.InferenceSession(model_dirs[static], device='cpu',
                              precision=precision,
                              int8_scope=_scope(precision))
    tiles = _tiles(3, 64, seed=9)
    batched = sess.run_tiles(tiles)
    again = sess.run_tiles(tiles)
    for k in batched:
        np.testing.assert_array_equal(batched[k], again[k])
    for i in range(3):
        single = sess.run_tiles(tiles[i:i + 1])
        for k in batched:
            np.testing.assert_array_equal(batched[k][i], single[k][0])


def test_cli_precision_options(model_dirs, tmp_path):
    inp = tmp_path / 'in'
    inp.mkdir()
    Image.fromarray(_tiles(1, 128, seed=2)[0]).save(inp / 'sample.png')
    common = dict(input_dir=str(inp), tile_size=128,
                  model_dir=model_dirs[False], device='cpu',
                  echo=lambda *a: None)
    with pytest.raises(NotImplementedError, match='int8 scope all'):
        cli.run_test(output_dir=str(tmp_path / 'a'), precision='int8',
                     **common)
    for precision in ('bfloat16', 'int8'):
        out = tmp_path / precision
        cli.run_test(output_dir=str(out), precision=precision,
                     int8_scope=_scope(precision), **common)
        names = sorted(os.listdir(out))
        assert 'sample.json' in names and 'sample_Seg.png' in names
        assert len(names) == 6, names
