"""bfloat16 and int8 (ResNet-trunk scope) pieces of the port against the JAX
package, on the CPU: the plain versions of the trunk kernels against the
JAX Pallas kernels in interpret mode, the int8 weight quantization, and the
precision options of the engine. Inputs are made with numpy from a seed and
handed to both.

Tolerances:
- ``conv3x3_stats`` bf16 at (2, 32, 16, 128): y within one bf16 ulp
  (|d| <= 2**-7 |y_jax| + 1e-6: both round a float32 sum of the same exact
  products, taken in another order); stats within 1e-5 of the largest stat
  of their kind (float32 sums in another order).
- ``conv3x3_stats_int8`` at (2, 48, 16, 128), static and dynamic (three
  16-row chunks, so a halo row is quantized with the scale of the chunk
  that consumes it): y differs on at most 0.1 % of elements, each by at
  most 2 quantization steps of its output (one step: 127 * the output
  channel's dequant, times m/127 of the chunk in dynamic mode), plus one
  bf16 ulp; the JAX kernel's 127/m is computed in another program and can
  round one ulp apart, flipping values on a rounding boundary. Stats within
  1e-5 relative, as above.
- Dynamic scales: an identity kernel returns the chunk's max |u| bit for
  bit, equal to the host max over the chunk and its two halo rows, and
  equal to the JAX kernel's output.
- ``resblock_chain_int8``, 2 blocks: at most 0.1 % of the outputs differ,
  by at most 2**-5 of the largest output.
- Quantized weights (w_q, w_s, folded a_s): bit-equal to
  ``deepliif_tpu.nets.layers.quantize_conv_int8`` /
  ``quantize_conv_tree_int8`` on the same numpy weights.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepliif_tpu.nets import layers as L_jax
from deepliif_tpu.ops import fused_resblock as FR_jax
from deepliif_tpu_torch import models as M
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.ops import fused_resblock as FR, quant
from deepliif_tpu_torch.utils import checkpoints as ck
from test_inference import TINY_CFG

BF16_ULP = 2.0 ** -7
STATS_REL = 1e-5
INT8_FLIP_FRAC = 1e-3


def _bf16(a):
    """numpy float32 -> (the bf16-rounded values as float32 numpy, torch
    bf16 tensor, jax bf16 array), all holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    f = np.array(j.astype(jnp.float32))
    return f, torch.from_numpy(f).to(torch.bfloat16), j


def _stats_rel(got, ref):
    return max(float(np.abs(got[:, q] - ref[:, q]).max()
                     / np.abs(ref[:, q]).max()) for q in range(2))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _affine(rng, s, c):
    return ((1 + 0.1 * rng.normal(0, 1, (s, c))).astype(np.float32),
            (0.1 * rng.normal(0, 1, (s, c))).astype(np.float32))


@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine_relu'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_conv3x3_stats_bf16_matches_jax(affine, padding):
    rng = np.random.default_rng(0)
    s, c = 2, 128
    _, xt, xj = _bf16(rng.normal(0, 1, (s, 32, 16, c)).astype(np.float32))
    _, wt, wj = _bf16(rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32))
    sc, bi = _affine(rng, s, c)
    y_ref, st_ref = FR_jax.conv3x3_stats(
        xj, wj, padding=padding, in_scale=jnp.asarray(sc) if affine else None,
        in_bias=jnp.asarray(bi) if affine else None, in_relu=affine,
        interpret=True)
    y, st = FR.conv3x3_stats(
        xt, wt, padding=padding,
        in_scale=torch.from_numpy(sc) if affine else None,
        in_bias=torch.from_numpy(bi) if affine else None, in_relu=affine)
    assert y.dtype == torch.bfloat16 and y.shape == xt.shape
    y_ref = _np(y_ref)
    assert (np.abs(_np(y) - y_ref) <= BF16_ULP * np.abs(y_ref) + 1e-6).all()
    assert _stats_rel(st.numpy(), np.asarray(st_ref)) < STATS_REL


def _quant_w(rng, c):
    w = rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32)
    s = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    return (np.clip(np.rint(w / s), -127, 127).astype(np.int8),
            s.astype(np.float32))


def _int8_both(x, wq, deq, inv_a, dynamic, padding, sc=None, bi=None):
    _, xt, xj = _bf16(x)
    aff = sc is not None
    yj, sj = FR_jax.conv3x3_stats_int8(
        xj, jnp.asarray(wq), jnp.asarray(deq),
        1.0 if inv_a is None else jnp.asarray(inv_a), padding=padding,
        in_scale=jnp.asarray(sc) if aff else None,
        in_bias=jnp.asarray(bi) if aff else None, in_relu=aff,
        interpret=True, dynamic=dynamic)
    yt, st = FR.conv3x3_stats_int8(
        xt, torch.from_numpy(wq), torch.from_numpy(deq),
        None if inv_a is None else torch.from_numpy(inv_a), padding=padding,
        in_scale=torch.from_numpy(sc) if aff else None,
        in_bias=torch.from_numpy(bi) if aff else None, in_relu=aff,
        dynamic=dynamic)
    return (_np(yj), np.asarray(sj)), (yt, st)


def _chunk_max(x, sc, bi, padding):
    """(S, H/16) max |u| over each 16-row chunk and its two halo rows, u
    the bf16 affine + ReLU of x."""
    _, xt, _ = _bf16(x)
    u = FR._transform(xt, torch.from_numpy(sc), torch.from_numpy(bi),
                      True).float().numpy()
    up = np.pad(u, ((0, 0), (1, 1), (0, 0), (0, 0)),
                mode='reflect' if padding == 'reflect' else 'constant')
    return np.stack([np.abs(up[:, r * 16:r * 16 + 18]).max(axis=(1, 2, 3))
                     for r in range(x.shape[1] // 16)], axis=1)


@pytest.mark.parametrize('dynamic', [False, True], ids=['static', 'dynamic'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_conv3x3_stats_int8_matches_jax(dynamic, padding):
    rng = np.random.default_rng(1)
    s, h, w, c = 2, 48, 16, 128
    x = rng.normal(0, 1, (s, h, w, c)).astype(np.float32)
    x[:, 16:32] *= 3.0              # chunks of different ranges
    wq, ws = _quant_w(rng, c)
    inv_a = (127.0 / rng.uniform(2.0, 6.0, c)).astype(np.float32)
    sc, bi = _affine(rng, s, c)
    (yj, sj), (yt, st) = _int8_both(x, wq, ws, None if dynamic else inv_a,
                                    dynamic, padding, sc, bi)
    assert yt.dtype == torch.bfloat16 and yt.shape == (s, h, w, c)
    # one quantization step of each output: 127 * its dequant scale
    step = 127.0 * np.broadcast_to(ws, (s, h, w, c))
    if dynamic:
        step = step * _chunk_max(x, sc, bi, padding)[:, :, None, None, None]\
            .repeat(16, axis=2).reshape(s, h, 1, 1) / 127.0
    d = np.abs(_np(yt) - yj)
    flips = d > 0
    assert flips.mean() <= INT8_FLIP_FRAC
    assert (d <= 2 * step + BF16_ULP * np.abs(yj)).all()
    assert _stats_rel(st.numpy(), sj) < STATS_REL


def test_int8_dynamic_scale_is_the_chunk_window_max():
    """Identity kernel (center tap = I, deq = 1): the output at a chunk's
    argmax is +-m. Each of the 3 chunks of H = 48 gets a spike inside it,
    larger than everything in its window (halo rows included)."""
    rng = np.random.default_rng(2)
    s, h, w, c = 2, 48, 16, 128
    x = rng.normal(0, 1, (s, h, w, c)).astype(np.float32)
    spikes = np.zeros((s, h // 16), np.float32)
    for i in range(s):
        for r in range(h // 16):
            spikes[i, r] = 8 + i + 0.5 * r
            x[i, r * 16 + 5, 3 * r, 7 * r] = spikes[i, r] * (-1) ** r
    eye = np.zeros((3, 3, c, c), np.int8)
    eye[1, 1] = np.eye(c, dtype=np.int8)
    (yj, _), (yt, _) = _int8_both(x, eye, np.ones(c, np.float32), None, True,
                                  'reflect')
    got = np.abs(_np(yt)).reshape(s, h // 16, 16, w, c).max(axis=(2, 3, 4))
    xp = np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)), mode='reflect')
    host = np.stack([np.abs(xp[:, r * 16:r * 16 + 18]).max(axis=(1, 2, 3))
                     for r in range(h // 16)], axis=1)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, spikes)
    np.testing.assert_array_equal(_np(yt), yj)


def test_int8_chunk_rows_gate():
    x = torch.zeros((1, 24, 16, 8), dtype=torch.bfloat16)
    wq = torch.zeros((3, 3, 8, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match='H % 16'):
        FR.conv3x3_stats_int8(x, wq, torch.ones(8), dynamic=True)


@pytest.mark.parametrize('dynamic', [False, True], ids=['static', 'dynamic'])
def test_resblock_chain_int8_matches_jax(dynamic):
    """Two int8 blocks, plain chain vs the JAX chain in interpret mode: at
    most 0.1 % of the outputs differ (as for one conv), by at most 2**-5 of
    the largest output (a flipped step can move a norm's statistics)."""
    rng = np.random.default_rng(3)
    s, h, w, c = 2, 32, 16, 128
    x = rng.normal(0, 1, (s, h, w, c)).astype(np.float32)
    _, xt, xj = _bf16(x)
    blocks = []
    for _ in range(2):
        b = {}
        for j in (1, 2):
            b[f'w{j}q'], b[f'w{j}s'] = _quant_w(rng, c)
            b[f'a{j}'] = np.float32(4.0 / 127.0)
            b[f'norm{j}'] = {
                'scale': (1 + 0.02 * rng.normal(0, 1, c)).astype(np.float32),
                'bias': (0.01 * rng.normal(0, 1, c)).astype(np.float32)}
        blocks.append(b)

    def tree(conv):
        return [{k: ({kk: conv(vv) for kk, vv in v.items()}
                     if isinstance(v, dict) else conv(v))
                 for k, v in b.items()} for b in blocks]
    ref = FR_jax.resblock_chain_int8(xj, tree(jnp.asarray), padding='zero',
                                     interpret=True, dynamic=dynamic)
    got = FR.resblock_chain_int8(xt, tree(torch.as_tensor), padding='zero',
                                 dynamic=dynamic)
    d = np.abs(_np(got) - _np(ref))
    assert (d > 0).mean() <= INT8_FLIP_FRAC
    assert d.max() <= 2.0 ** -5 * np.abs(_np(ref)).max()


def test_quantize_conv_int8_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.05, (3, 3, 32, 48)).astype(np.float32)
    w[..., 5] = 0.0                                    # the 1e-12 floor
    ref = L_jax.quantize_conv_int8({'w': jnp.asarray(w)})
    w_q, w_s = quant.quantize_conv_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(ref['w_q']))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(ref['w_s']))


@pytest.mark.parametrize('per_channel', [True, False],
                         ids=['per_channel', 'per_tensor'])
def test_static_folding_bit_equal_to_jax(per_channel):
    """``quantize_conv_tree_int8`` over a stacked group of 4 nets with one
    act-scale entry per path (shared by the nets) vs the port's per-net
    ``quantize_conv_int8_static``."""
    rng = np.random.default_rng(5)
    c = 64
    w = rng.normal(0, 0.02, (4, 3, 3, c, c)).astype(np.float32)
    scale = (rng.uniform(0.5, 6.0, c).astype(np.float32).tolist()
             if per_channel else 3.25)
    tree = {'G': {'res0_conv1': {'w': jnp.asarray(w)},
                  'down0_conv': {'w': jnp.asarray(w)}}}
    ref = L_jax.quantize_conv_tree_int8(
        tree, act_scales={'G/res0_conv1': scale, 'G/down0_conv': scale},
        scope='resblocks')
    assert 'w_q' not in ref['G']['down0_conv']
    r = ref['G']['res0_conv1']
    for i in range(4):
        w_q, w_s, a_s = quant.quantize_conv_int8_static(
            torch.from_numpy(w[i]), scale)
        np.testing.assert_array_equal(w_q.numpy(), np.asarray(r['w_q'][i]))
        np.testing.assert_array_equal(w_s.numpy(), np.asarray(r['w_s'][i]))
        np.testing.assert_array_equal(a_s.numpy(), np.asarray(r['a_s'][i]))


def test_scope_predicate_matches_jax():
    paths = ['G/res0_conv1', 'G/res12_conv2', 'res3_conv1', 'G/down0_conv',
             'GS/sub/downconv', 'G/up1_conv', 'G/head_conv', 'xres0_conv1']
    for scope in ('all', 'resblocks'):
        ref, got = L_jax.int8_scope_predicate(scope), \
            quant.int8_scope_predicate(scope)
        assert (ref is None) == (got is None)
        if got is not None:
            assert [got(p) for p in paths] == [ref(p) for p in paths]
    with pytest.raises(ValueError):
        quant.int8_scope_predicate('trunk')


def write_model_dir(md, seed=11):
    """A native model dir both packages load: ngf 32 (trunk C = 128, the
    JAX fused-kernel gate), 2 resnet_2blocks translators, 3 unet_32 seg
    nets, weights at the reference init (conv N(0, 0.02), norm scale
    N(1, 0.02), biases 0) drawn with numpy."""
    d = dl.DeepLIIFDef(modalities_no=2, net_g=('resnet_2blocks',) * 2,
                       net_gs=('unet_32',) * 3, ngf=32,
                       seg_weights=(0.4, 0.3, 0.3))
    ens = dl.DeepLIIFNets(d)
    rng = np.random.default_rng(seed)
    for group, nets_ in (('G', ens.G), ('GS', ens.GS)):
        flat = ck.flatten_tree(ck.params_to_jax(nets_[0]))
        out = {}
        for k, v in flat.items():
            shape = (len(nets_),) + v.shape
            if k.endswith('/w'):
                out[k] = rng.normal(0, 0.02, shape).astype(np.float32)
            elif k.endswith('/scale'):
                out[k] = (1 + 0.02 * rng.normal(0, 1, shape)).astype(np.float32)
            else:
                out[k] = np.zeros(shape, np.float32)
        np.savez(os.path.join(md, f'latest_net_{group}.npz'), **out)
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump(dict(TINY_CFG, netG='resnet_2blocks', ngf=32,
                       scale_size=128), f)
    return str(md)


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    return write_model_dir(tmp_path_factory.mktemp('port_precision_model'))


def _act_scales(c=128, n_blocks=2):
    rng = np.random.default_rng(6)
    return {f'G/res{i}_conv{j}': rng.uniform(1.0, 4.0, c).tolist()
            for i in range(n_blocks) for j in (1, 2)}


@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
def test_session_int8_weights_bit_equal_to_jax(model_dir, tmp_path, monkeypatch,
                                               static):
    """The int8 trunk parameters the port derives from the f32 checkpoint
    (and act_scales.json) equal the JAX session's, net by net."""
    from deepliif_tpu import models as M_jax

    md = model_dir
    if static:
        md = str(tmp_path)
        for fn in os.listdir(model_dir):
            with open(os.path.join(model_dir, fn), 'rb') as src, \
                    open(os.path.join(md, fn), 'wb') as dst:
                dst.write(src.read())
        with open(os.path.join(md, 'act_scales.json'), 'w') as f:
            json.dump({'scales': _act_scales()}, f)
    monkeypatch.setenv('DEEPLIIF_INT8_SCOPE', 'resblocks')
    ref = M_jax.InferenceSession(md, n_devices=1, precision='int8').params['G']
    sess = M.InferenceSession(md, device='cpu', precision='int8',
                              int8_scope='resblocks')
    for i, net in enumerate(sess.nets.G):
        assert net.int8_mode == ('static' if static else 'dynamic')
        for b, blk in enumerate(net.trunk_blocks()):
            for j in (1, 2):
                r = ref[f'res{b}_conv{j}']
                np.testing.assert_array_equal(blk[f'w{j}q'].numpy(),
                                              np.asarray(r['w_q'][i]))
                np.testing.assert_array_equal(blk[f'w{j}s'].numpy(),
                                              np.asarray(r['w_s'][i]))
                if static:
                    np.testing.assert_array_equal(blk[f'a{j}'].numpy(),
                                                  np.asarray(r['a_s'][i]))
        assert 'w_q' not in ref['down0_conv']


def test_int8_scope_all_and_partial_scales_raise(model_dir, tmp_path):
    """Scope 'all' is the default and runs (it raised before the port had
    it); an unknown scope raises; an act_scales.json for 3 of the 4
    resblock convs runs the unfused int8 trunk (it raised before the port
    had that trunk)."""
    for scope in (None, 'all'):
        sess = M.InferenceSession(model_dir, device='cpu', precision='int8',
                                  int8_scope=scope)
        assert sess.int8_scope == 'all'
        assert 'down0_conv' in sess.nets.G[0].int8
        assert sess.nets.G[0].int8_mode == 'dynamic'
    with pytest.raises(ValueError):
        M.InferenceSession(model_dir, device='cpu', precision='int8',
                           int8_scope='trunk')
    md = str(tmp_path)
    for fn in os.listdir(model_dir):
        with open(os.path.join(model_dir, fn), 'rb') as src, \
                open(os.path.join(md, fn), 'wb') as dst:
            dst.write(src.read())
    scales = _act_scales()
    scales.pop('G/res1_conv2')
    with open(os.path.join(md, 'act_scales.json'), 'w') as f:
        json.dump(scales, f)
    sess = M.InferenceSession(md, device='cpu', precision='int8',
                              int8_scope='resblocks')
    assert sess.nets.G[0].int8_mode == 'unfused'
    assert set(sess.nets.G[0].int8) == {f'res{i}_conv{j}' for i in range(2)
                                        for j in (1, 2)}
    tiles = np.random.default_rng(0).integers(0, 255, (1, 64, 64, 3),
                                              np.uint8)
    assert sess.run_tiles(tiles)['G1'].shape == (1, 64, 64, 3)


def test_int8_fused_gate_raises(model_dir):
    """96^2 tiles put a 24 x 24 trunk under the fused kernel's H % 16
    gate; the port runs the unfused int8 trunk there, as the JAX package
    runs its XLA int8 path (it raised before the port had that trunk).
    Calibration is off, so the shared model dir stays without
    act_scales.json."""
    sess = M.InferenceSession(model_dir, device='cpu', precision='int8',
                              int8_scope='resblocks', int8_calibrate=False)
    tiles = np.random.default_rng(0).integers(0, 255, (1, 96, 96, 3), np.uint8)
    out = sess.run_tiles(tiles)
    assert sess.nets.G[0].int8_mode == 'dynamic'
    assert out['G1'].shape == (1, 96, 96, 3)
    assert not os.path.exists(os.path.join(model_dir, 'act_scales.json'))


def test_session_precision_from_config_and_defaults(model_dir, tmp_path):
    sess = M.InferenceSession(model_dir, device='cpu', precision='bfloat16')
    assert sess.d.dtype == torch.bfloat16 and not sess.d.quant_int8
    assert sess.max_batch == M.DEFAULT_MAX_BATCH
    assert all(n.compute_dtype == torch.bfloat16
               for n in list(sess.nets.G) + list(sess.nets.GS))
    assert all(p.dtype == torch.float32 for p in sess.nets.parameters())
    md = str(tmp_path)
    for fn in os.listdir(model_dir):
        with open(os.path.join(model_dir, fn), 'rb') as src, \
                open(os.path.join(md, fn), 'wb') as dst:
            dst.write(src.read())
    with open(os.path.join(md, 'config.json')) as f:
        cfg = json.load(f)
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump(dict(cfg, precision='bfloat16'), f)
    assert M.InferenceSession(md, device='cpu').precision == 'bfloat16'
    assert M.InferenceSession(md, device='cpu',
                              precision='float32').d.dtype == torch.float32


def test_bf16_weight_casts_are_cached(model_dir):
    """Conv weights are cast to bf16 once per weight version, not per
    call; an in-place weight update rebuilds the cast."""
    sess = M.InferenceSession(model_dir, device='cpu', precision='bfloat16')
    g, gs = sess.nets.G[0], sess.nets.GS[0]
    x = torch.zeros((1, 3, 64, 64))
    with torch.no_grad():
        g(x)
        gs(x)
        t1, c1, u1 = g.trunk_blocks()[0]['w1'], g._cast(), gs._cast()
        head = c1(g.model[1].weight)
        down = u1(gs.model.model[0].weight)
        g(x)
        gs(x)
        assert g.trunk_blocks()[0]['w1'] is t1
        assert g._cast()(g.model[1].weight) is head
        assert gs._cast()(gs.model.model[0].weight) is down
        assert head.dtype == t1.dtype == down.dtype == torch.bfloat16
        g.model[1].weight.mul_(2.0)
        assert g._cast()(g.model[1].weight) is not head


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(7)
    _, xt, _ = _bf16(rng.normal(0, 1, (1, 16, 8, 8)).astype(np.float32))
    _, wt, _ = _bf16(rng.normal(0, 0.02, (3, 3, 8, 8)).astype(np.float32))
    wq, ws = _quant_w(rng, 8)
    before = (FR.conv3x3_stats.launches, FR.conv3x3_stats.launches_bf16,
              FR.conv3x3_stats_int8.launches)
    y, st = FR.conv3x3_stats(xt, wt, padding='zero')
    y_ref, st_ref = FR.conv3x3_stats_reference(xt, wt, padding='zero')
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    kw = dict(padding='zero', dynamic=True)
    y, st = FR.conv3x3_stats_int8(xt, torch.from_numpy(wq),
                                  torch.from_numpy(ws), **kw)
    y_ref, st_ref = FR.conv3x3_stats_int8_reference(
        xt, torch.from_numpy(wq), torch.from_numpy(ws), **kw)
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    assert (FR.conv3x3_stats.launches, FR.conv3x3_stats.launches_bf16,
            FR.conv3x3_stats_int8.launches) == before


@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_cuda_kernels_match_plain_versions(padding):
    """bf16 and int8 kernels vs their plain twins on the card (ragged W and
    C for bf16, H < 16 for int8); skipped without CUDA. chip_smoke.py runs
    the same checks at flagship shapes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(8)
    s, h, w, c = 2, 13, 21, 40
    _, xt, _ = _bf16(rng.normal(0, 1, (s, h, w, c)).astype(np.float32))
    _, wt, _ = _bf16(rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32))
    sc, bi = _affine(rng, s, c)
    args = dict(padding=padding, in_scale=torch.from_numpy(sc).cuda(),
                in_bias=torch.from_numpy(bi).cuda(), in_relu=True)
    y, st = FR.conv3x3_stats(xt.cuda(), wt.cuda(), **args)
    y_ref, st_ref = FR.conv3x3_stats_reference(xt.cuda(), wt.cuda(), **args)
    d = (y.float() - y_ref.float()).abs()
    assert bool((d <= BF16_ULP * y_ref.float().abs() + 1e-6).all())
    assert _stats_rel(st.cpu().numpy(), st_ref.cpu().numpy()) < STATS_REL
    wq, ws = _quant_w(rng, c)
    for dynamic in (False, True):
        kw = dict(args, dynamic=dynamic)
        inv = None if dynamic else torch.full((c,), 30.0).cuda()
        y, st = FR.conv3x3_stats_int8(xt.cuda(), torch.from_numpy(wq).cuda(),
                                      torch.from_numpy(ws).cuda(), inv, **kw)
        y_ref, st_ref = FR.conv3x3_stats_int8_reference(
            xt.cuda(), torch.from_numpy(wq).cuda(),
            torch.from_numpy(ws).cuda(), inv, **kw)
        assert torch.equal(y, y_ref)
        assert _stats_rel(st.cpu().numpy(), st_ref.cpu().numpy()) < STATS_REL
