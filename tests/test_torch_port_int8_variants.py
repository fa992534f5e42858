"""int8 on the nets beyond the flagship's, against the JAX package (CPU):
the attention U-Net at int8 scope 'all' (its 4x4 convs and conv-transposes
and its 1x1 attention convs with bias, each on the int8 route), and
spectral norm at int8 (the quantized convs on the raw weights, their float
route on the normalized ones, as the JAX package runs them).

Tolerances:
- the int8 convs of the attention U-Net (every 1x1 gate conv, the first
  4x4 conv and conv-transpose): bit-equal to the JAX package's
  ``layers.conv2d`` / ``conv_transpose2d`` on the same bf16 input (the
  quantized input, the exact int32 sums and the epilogue round at the same
  points), and the set of quantized convs equal to the JAX walk's;
- spectral-norm sessions, uint8 outputs: mean |d| <= 0.5 LSB and >= 97 %
  of pixels within 2 LSB (the int8 sessions' limit, PERF.md section 2;
  measured 0.008 LSB dynamic with the JAX session jitted)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepliif_tpu import models as M_jax
from deepliif_tpu.nets import layers as L_jax
from deepliif_tpu.utils import torch_import as ti
from deepliif_tpu_torch import models as M, nets
from deepliif_tpu_torch.nets import layers as L
from deepliif_tpu_torch.ops import conv_int8 as C, quant
from test_torch_import import _rand_init, torch_att_unet
from test_torch_port_norms import write_spectral_dir


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_att_unet_int8_convs_match_jax(monkeypatch):
    """Every int8 conv call of a bf16 attention U-Net forward at one 256^2
    sample, against the JAX package's conv on the same input and quantized
    params, with static scales from the port's calibration replay (the
    dynamic scales' quantize is held per conv kind in
    tests/test_torch_port_conv_s8.py, the 1x1 kind among them)."""
    static = True
    ref = _rand_init(torch_att_unet())
    params = ti._as_jnp(ti.import_att_unet(ref.state_dict()))
    net = nets.define_g(3, 3, 64, 'unet_512_attention')
    net.load_state_dict(ref.state_dict(), strict=True)
    net.eval().compute_dtype = torch.bfloat16
    x = np.random.default_rng(11).uniform(-1, 1, (1, 256, 256, 3))
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).permute(
        0, 3, 1, 2)
    keys = [n for n, w, _ in net.conv_layout()
            if min(w.shape[:2]) >= quant.MIN_CH]
    assert sorted(keys) == sorted(
        L_jax._quantizable_conv_paths(params).values())
    assert len(keys) == 28      # 7 down, 7 up, 14 attention 1x1
    cal = L.ActCalibration([f'A/{k}' for k in keys])
    with torch.no_grad():
        net.calibrate(xt, cal.at('A'))
    scales = {k.split('/', 1)[1]: v.tolist() for k, v in cal.out.items()}
    assert sorted(scales) == sorted(keys)
    qp = L_jax.quantize_conv_tree_int8(params,
                                       act_scales=scales if static else None)
    net.set_int8({k: scales[k] if static else None for k in keys})

    names = {id(w): n for n, w, _ in net.conv_layout()}
    calls = []

    def spy(fn, kind):
        def run(x, qc, bias=None, *args):
            y = fn(x, qc, bias, *args)
            calls.append((kind, x, qc, args, y))
            return y
        return run
    monkeypatch.setattr(C, 'conv2d_s8', spy(C.conv2d_s8, 'conv'))
    monkeypatch.setattr(C, 'conv_transpose2d_s8',
                        spy(C.conv_transpose2d_s8, 'convT'))
    with torch.no_grad():
        net(xt)
    by_qc = {id(qc): names[w_id]
             for w_id, qc in net._int8_convs._convs.items()}
    assert sorted(by_qc[id(c[2])] for c in calls) == sorted(keys)
    # against JAX: every 1x1 gate conv, and the first 4x4 conv and
    # conv-transpose (the 4x4 kinds are held per kind in
    # tests/test_torch_port_conv_s8.py)
    first = {kind: next(c for c in calls if c[0] == kind and
                        c[2].w_q.shape[0] == 4) for kind in ('conv', 'convT')}
    checked = [c for c in calls if c[2].w_q.shape[0] == 1]
    assert len(checked) == 14
    with jax.disable_jit():
        for kind, xin, qc, args, y in checked + list(first.values()):
            p = qp[by_qc[id(qc)]]
            xj = jnp.asarray(xin.float().numpy(), jnp.bfloat16)
            want = (L_jax.conv2d(xj, p, *args) if kind == 'conv'
                    else L_jax.conv_transpose2d(xj, p, *args))
            np.testing.assert_array_equal(
                y.float().numpy(), np.asarray(want.astype(jnp.float32)),
                err_msg=by_qc[id(qc)])


@pytest.fixture(scope='module')
def spectral_dir(tmp_path_factory):
    return write_spectral_dir(str(tmp_path_factory.mktemp('spectral8')))


def test_int8_spectral_sessions_match_jax(spectral_dir, tmp_path,
                                            monkeypatch):
    """int8 with spectral norm, dynamic then static scales: the quantized
    convs on the raw weights, their float route past the dynamic gate and
    every float conv on the normalized ones; static scales from the port's
    calibration replay (on the normalized float weights) in both
    packages."""
    md = str(tmp_path / 'md')
    shutil.copytree(spectral_dir, md)
    for k in ('DEEPLIIF_INT8_SCOPE', 'DEEPLIIF_INT8_CALIB_PCT',
              'DEEPLIIF_FUSED'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('DEEPLIIF_INFER_DEVICES', '1')
    tiles = np.random.default_rng(13).integers(0, 255, (1, 64, 64, 3),
                                               np.uint8)
    # a dynamic gate of 16^2 sends the quantized convs with larger inputs
    # (the translator's down1, the U-Nets' second downconv) to their float
    # route
    monkeypatch.setattr(L_jax, '_INT8_MAX_SPATIAL', 16 * 16)
    monkeypatch.setattr(quant, 'INT8_MAX_SPATIAL', 16 * 16)
    monkeypatch.setenv('DEEPLIIF_INT8_CALIBRATE', '0')
    for calibrate in (False, True):
        # static: the port calibrates and writes act_scales.json, which the
        # JAX session then reads (the JAX calibration replay runs eagerly,
        # too slow for the suite)
        sess = M.InferenceSession(md, device='cpu', precision='int8',
                                  int8_calibrate=calibrate)
        got = sess.run_tiles(tiles)
        assert sess.nets.G[0].int8
        assert os.path.exists(os.path.join(md, 'act_scales.json')) \
            == calibrate
        ref = M_jax.InferenceSession(md, n_devices=1,
                                     precision='int8').run_tiles(tiles)
        assert set(got) == set(ref)
        for k in ref:
            d = np.abs(got[k].astype(np.int16) - ref[k].astype(np.int16))
            assert d.mean() <= 0.5 and (d <= 2).mean() >= 0.97, (
                calibrate, k, d.mean(), (d <= 2).mean())
