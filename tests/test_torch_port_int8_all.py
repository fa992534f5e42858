"""int8 scope 'all' of the port against the JAX package on the CPU: which
convs quantize and their weights, calibration and act_scales.json, the
sessions (static and dynamic), the unfused int8 trunk, determinism and the
CLI. Model dir: ngf 16 (the min_ch gate admits every conv but the heads and
tails; the trunk is 64 wide, under the fused kernel's C % 128, so both
packages run the unfused int8 trunk), 2 resnet_2blocks translators, 3
unet_32 seg nets, weights at the reference init from a numpy seed. The JAX
side runs eagerly (``jax.disable_jit()``), whose bf16 rounding points the
port implements.

Tolerances:
- weights, scales and the set of quantized convs: bit-equal;
- calibration: the same keys; per-channel ranges of the translators within
  2^-7 relative, one bf16 ulp (the two packages' bf16 float convs, summed
  in other orders, round a value one ulp apart now and then, and a max or
  a percentile moves by as much); of the seg nets, up to five convs deep
  in a U-Net, within 2^-5 (measured 2^-6.0: the ulps compound through the
  norms); end to end, where the seg nets also take the translators'
  outputs (which differ by up to 5 bf16 ulps on 40 % of the pixels),
  within 2^-4 (measured 2^-5.4). A recorder on the wrong keys, axis, pad
  or statistic is off by far more;
- sessions on IHC-like tiles (the input the system is for), uint8 outputs:
  mean |d| <= 0.5 LSB (the sessions' limit of PERF.md section 2) and
  >= 97 % of pixels within 2 LSB; no less accurate against the float32
  session than the JAX session, up to 5 %; equal cell counts. Each int8
  conv is bit-equal to the JAX package's on the same input
  (test_torch_port_conv_s8.py) and the unfused int8 trunk bit-equal on
  the same input (below), but the float convs around them round a few
  bf16 values one ulp apart (8 of 524288 after a translator's head conv),
  and a static or per-sample scale turns such an ulp into a flipped
  quantization step now and then, which the norms spread: measured, one
  translator bit-equal in uint8, the other 0.35 LSB mean and 98.3 %
  within 2 LSB (static), while both sessions stay 2.5-2.9 LSB from float32
  and equally far to 0.1 %. The dynamic session stays within 0.19 LSB.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from deepliif_tpu import models as M_jax
from deepliif_tpu_torch import cli, models as M, roadmap
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.ops import quant
from deepliif_tpu_torch.utils import checkpoints as ck
from test_torch_port_precision import TINY_CFG, write_model_dir
from test_torch_port_precision_slice import ihc_like_image

# (max mean |d| in LSB, min share of pixels within 2 LSB)
SESSION_TOL = (0.5, 0.97)
ACCURACY_MARGIN = 1.05
CALIB_REL = {'G/': 2.0 ** -7, 'GS': 2.0 ** -5, 'session': 2.0 ** -4}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    """The JAX package's int8 settings at their defaults (scope all,
    calibration on, one device)."""
    for k in ('DEEPLIIF_INT8_SCOPE', 'DEEPLIIF_INT8_CALIBRATE',
              'DEEPLIIF_INT8_CALIB_PCT', 'DEEPLIIF_FUSED'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('DEEPLIIF_INFER_DEVICES', '1')


def write_ngf16_model_dir(md, seed=11):
    d = dl.DeepLIIFDef(modalities_no=2, net_g=('resnet_2blocks',) * 2,
                       net_gs=('unet_32',) * 3, ngf=16,
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
                out[k] = (1 + 0.02 * rng.normal(0, 1, shape)).astype(
                    np.float32)
            else:
                out[k] = np.zeros(shape, np.float32)
        np.savez(os.path.join(md, f'latest_net_{group}.npz'), **out)
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump(dict(TINY_CFG, netG='resnet_2blocks', ngf=16,
                       scale_size=128), f)
    return str(md)


@pytest.fixture(scope='module')
def base_dir(tmp_path_factory):
    return write_ngf16_model_dir(tmp_path_factory.mktemp('int8_all_model'))


def _copy(src, dst):
    os.makedirs(dst, exist_ok=True)
    for fn in os.listdir(src):
        if fn != 'act_scales.json':
            shutil.copy(os.path.join(src, fn), dst)
    return str(dst)


def _tiles(n=4, size=128, seed=0):
    big = ihc_like_image(2 * size, 2 * size, seed)
    tiles = [big[y:y + size, x:x + size]
             for y in (0, size) for x in (0, size)]
    return np.stack(tiles[:n])


def _jax_quantized(params, prefix=''):
    """{key: (w_q, w_s, a_s or None)} of the JAX params' quantized convs."""
    out = {}
    for k, v in params.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict) and 'w_q' in v:
            out[key] = tuple(np.asarray(v[n]) if n in v else None
                             for n in ('w_q', 'w_s', 'a_s'))
        elif isinstance(v, dict):
            out.update(_jax_quantized(v, key + '/'))
    return out


def _port_quantized(nets_):
    """{key: [(w_q, w_s, a_s or None) per net of the group]}."""
    out = {}
    for key, convs in dl.quantizable_convs(nets_).items():
        for net, name in convs:
            if name not in net.int8:
                continue
            w = dict((n, w) for n, w, _ in net.conv_layout())[name]
            qc = net._cast()(w)
            out.setdefault(key, []).append(
                (qc.w_q.numpy(), qc.w_s.numpy(),
                 None if qc.a_s is None else qc.a_s.numpy()))
    return out


def assert_weights_equal(md):
    """The port session's quantized convs equal the JAX session's (built
    from the same model dir and act_scales.json, if any), net by net."""
    ref = _jax_quantized(M_jax.InferenceSession(md, precision='int8').params)
    got = _port_quantized(M.InferenceSession(md, device='cpu',
                                             precision='int8').nets)
    assert ref and set(got) == set(ref)
    for key, per_net in got.items():
        for i, (w_q, w_s, a_s) in enumerate(per_net):
            r_q, r_s, r_a = ref[key]
            np.testing.assert_array_equal(w_q, r_q[i], err_msg=key)
            np.testing.assert_array_equal(w_s, r_s[i], err_msg=key)
            assert (a_s is None) == (r_a is None), key
            if a_s is not None:
                np.testing.assert_array_equal(a_s, r_a[i], err_msg=key)
    return set(got)


def test_quantized_convs_and_weights_match_jax(base_dir, tmp_path):
    """Dynamic (no act_scales.json) and static (a synthetic per-channel
    file for every quantizable conv, one per-tensor): the same non-empty
    set of convs quantizes in both packages, with bit-equal w_q, w_s and
    a_s; 16 convs per translator and unet_32 seg net at ngf 16."""
    keys = assert_weights_equal(base_dir)
    nets_ = M.InferenceSession(base_dir, device='cpu', precision='int8').nets
    assert [len(n.int8) for n in list(nets_.G) + list(nets_.GS)] == \
        [8, 8, 8, 8, 8]
    md = _copy(base_dir, tmp_path / 'static')
    rng = np.random.default_rng(1)
    scales = {}
    for i, key in enumerate(sorted(keys)):
        cin = _cin(nets_, key)
        scales[key] = (float(rng.uniform(1, 4)) if i == 0 else
                       rng.uniform(0.5, 6.0, cin).tolist())
    with open(os.path.join(md, 'act_scales.json'), 'w') as f:
        json.dump({'scales': scales}, f)
    assert assert_weights_equal(md) == keys


def _cin(nets_, key):
    net, name = dl.quantizable_convs(nets_)[key][0]
    w = dict((n, (w, k)) for n, w, k in net.conv_layout())[name]
    return w[0].shape[1] if w[1] == 'conv' else w[0].shape[0]


def _rel(got, ref):
    r, g = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert r.shape == g.shape
    return float((np.abs(g - r) / np.maximum(np.abs(r), 1e-6)).max())


@pytest.mark.parametrize('pct', [100.0, 99.9])
def test_calibration_matches_jax(base_dir, pct):
    """Each net's recorded conv inputs on the same bf16 input (the
    translators on the tiles, the seg nets on the tiles and on the JAX
    translators' outputs) against the JAX package's ``act_calibration``,
    then the sessions' ``calibrate_int8`` end to end: the same keys, every
    resblock conv included, per-channel ranges within CALIB_REL."""
    from deepliif_tpu.models import deepliif as dl_jax
    from deepliif_tpu.nets import layers as L_jax
    from deepliif_tpu_torch.nets import layers as L

    tiles = _tiles(2)
    sess_j = M_jax.InferenceSession(base_dir, precision='int8')
    raw, d_j = sess_j._load_params(base_dir), sess_j.d
    sess = M.InferenceSession(base_dir, device='cpu', precision='int8')
    x = (torch.from_numpy(tiles).float() / 127.5 - 1.0).to(torch.bfloat16)
    xj = jax.numpy.asarray(x.float().numpy(), jax.numpy.bfloat16)
    ref, mods_j = {}, []
    cal = L.ActCalibration(dl.quantizable_convs(sess.nets), pct=pct)
    with jax.disable_jit(), torch.no_grad():
        for group, nets_ in (('G', sess.nets.G), ('GS', sess.nets.GS)):
            for i, net in enumerate(nets_):
                p_i = jax.tree_util.tree_map(lambda a: a[i], raw[group])
                xin = xj if group == 'G' or i == 0 else mods_j[i - 1]
                arch = (d_j.net_g if group == 'G' else d_j.net_gs)[i]
                net_j = (dl_jax._g_net if group == 'G' else
                         dl_jax._gs_net)(d_j, arch)
                with L_jax.act_calibration(p_i, (group,), ref, pct=pct):
                    y = net_j.apply(p_i, xin)
                if group == 'G':
                    mods_j.append(y)
                xt = torch.from_numpy(np.array(xin.astype(jax.numpy.float32)))
                net.calibrate(xt.to(torch.bfloat16).permute(0, 3, 1, 2),
                              cal.at(group))
    assert set(cal.out) == set(ref)
    assert {'G/res0_conv1', 'G/res1_conv2', 'GS/sub/sub/sub/upconv'} <= \
        set(ref)
    for k in ref:
        assert _rel(cal.out[k], ref[k]) <= CALIB_REL[k[:2]], k
    with jax.disable_jit():
        ref = sess_j.calibrate_int8(tiles, save=False, pct=pct)
    got = sess.calibrate_int8(tiles, save=False, pct=pct)
    assert set(got) == set(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= CALIB_REL['session'], k


@pytest.mark.parametrize('per_channel, pct', [(True, 100.0), (True, 99.9),
                                                (False, 100.0),
                                                (False, 99.9)])
def test_recorder_matches_act_calibration(per_channel, pct):
    """``layers.ActCalibration`` against the JAX package's
    ``act_calibration`` on the same conv inputs, two batches max-merged:
    per input channel (max, or the percentile) or per tensor (the max;
    the JAX package ignores ``pct`` there). Maxima are equal; a percentile
    within 2^-16 relative: its float32 interpolation between two order
    statistics, which XLA may contract into one multiply-add (measured
    9.4e-6)."""
    from deepliif_tpu.nets import layers as L_jax
    from deepliif_tpu_torch.nets import layers as L

    rng = np.random.default_rng(7)
    tree = {'c': {'w': jax.numpy.asarray(
        rng.normal(0, 0.02, (3, 3, 16, 16)).astype(np.float32))}}
    ref, cal = {}, L.ActCalibration({'G/c'}, per_channel=per_channel,
                                    pct=pct)
    for scale in (1.0, 3.0):
        x = (scale * rng.standard_t(3, (2, 12, 10, 16))).astype(np.float32)
        xj = jax.numpy.asarray(x, jax.numpy.bfloat16)
        with L_jax.act_calibration(tree, ('G',), ref, per_channel=per_channel,
                                   pct=pct):
            L_jax.conv2d(xj, tree['c'], 1, 1)
        xt = torch.from_numpy(np.array(xj.astype(jax.numpy.float32)))
        cal.record('G/c', xt.to(torch.bfloat16).permute(0, 3, 1, 2))
        cal.record('G/not_admitted', xt.permute(0, 3, 1, 2))
    assert set(cal.out) == set(ref) == {'G/c'}
    np.testing.assert_allclose(np.asarray(cal.out['G/c'], np.float32),
                               np.asarray(ref['G/c'], np.float32),
                               rtol=2.0 ** -16 if pct < 100 else 0)


def test_act_scales_json_round_trip(base_dir, tmp_path):
    """A file the port's session writes gives the JAX session the port's
    w_q and w_s, and a file the JAX session writes gives the port the
    JAX's."""
    tiles = _tiles(2)
    for writer in ('port', 'jax'):
        md = _copy(base_dir, tmp_path / writer)
        if writer == 'port':
            M.InferenceSession(md, device='cpu', precision='int8') \
                .calibrate_int8(tiles)
        else:
            with jax.disable_jit():
                M_jax.InferenceSession(md, precision='int8') \
                    .calibrate_int8(tiles)
        with open(os.path.join(md, 'act_scales.json')) as f:
            doc = json.load(f)
        assert set(doc) == {'scales', 'pct', 'n_tiles'}
        assert doc['n_tiles'] == 2 and doc['pct'] == 100.0
        assert_weights_equal(md)


def _assert_u8_close(a, b):
    a = np.asarray(a).astype(np.int16)
    b = np.asarray(b).astype(np.int16)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.mean() <= SESSION_TOL[0], d.mean()
    assert (d <= 2).mean() >= SESSION_TOL[1], (d <= 2).mean()


@pytest.fixture(scope='module')
def calibrated_dir(base_dir, tmp_path_factory):
    """The model dir with act_scales.json as the JAX session writes it on
    its first tiles (both sessions then quantize bit-equal weights)."""
    md = _copy(base_dir, tmp_path_factory.mktemp('int8_all_calibrated'))
    with jax.disable_jit():
        M_jax.InferenceSession(md, precision='int8').calibrate_int8(
            _tiles(4, seed=3))
    return md


@pytest.fixture(scope='module')
def float32_images(base_dir):
    """The port's float32 session on the session test's image: the
    reference both int8 sessions' accuracy is read against (the two
    packages' float32 sessions agree to the float32 layer tolerance,
    test_torch_port_inference.py)."""
    img = Image.fromarray(ihc_like_image(128, 200, seed=1))
    return img, M.infer_modalities(img, 128, base_dir, device='cpu',
                                   precision='float32')[0]


def _mean_u8(a, b):
    return float(np.abs(np.asarray(a).astype(np.int16)
                        - np.asarray(b).astype(np.int16)).mean())


@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
def test_session_matches_jax(base_dir, calibrated_dir, float32_images,
                             monkeypatch, static):
    """The int8 'all' sessions through ``infer_modalities`` (a 128 x 200
    IHC-like image, two 128^2 tiles): static from the JAX-written
    act_scales.json, dynamic with calibration off in both packages. Close
    to the JAX session (SESSION_TOL), as accurate against the float32
    session (ACCURACY_MARGIN), the same cell counts."""
    md = calibrated_dir if static else base_dir
    if not static:
        monkeypatch.setenv('DEEPLIIF_INT8_CALIBRATE', '0')
    img, f32 = float32_images
    with jax.disable_jit():
        ref_images, ref_scoring = M_jax.infer_modalities(img, 128, md,
                                                         precision='int8')
    images, scoring = M.infer_modalities(img, 128, md, device='cpu',
                                         precision='int8',
                                         int8_calibrate=static)
    session = M.init_nets(md, precision='int8', device='cpu',
                          int8_calibrate=static)
    assert [g.int8_mode for g in session.nets.G] == \
        ['static' if static else 'dynamic'] * 2
    assert not os.path.exists(os.path.join(base_dir, 'act_scales.json'))
    assert set(images) == set(ref_images)
    for k in ref_images:
        _assert_u8_close(images[k], ref_images[k])
        if k.startswith('mod') or k == 'Seg':
            got, want = _mean_u8(images[k], f32[k]), \
                _mean_u8(ref_images[k], f32[k])
            assert got <= ACCURACY_MARGIN * want + 0.01, (k, got, want)
    for k in ('num_total', 'num_pos', 'num_neg'):
        assert scoring[k] == ref_scoring[k], (k, scoring, ref_scoring)


@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
def test_batch_invariance_and_run_to_run(base_dir, calibrated_dir, static):
    """A tile's outputs do not depend on the batch it rides in (per-sample
    dynamic scales, exact int32 sums), and two runs are byte-equal."""
    sess = M.InferenceSession(calibrated_dir if static else base_dir,
                              device='cpu', precision='int8',
                              int8_calibrate=False)
    tiles = _tiles(3, 64, seed=9)
    batched = sess.run_tiles(tiles)
    again = sess.run_tiles(tiles)
    for k in batched:
        np.testing.assert_array_equal(batched[k], again[k])
    for i in range(3):
        single = sess.run_tiles(tiles[i:i + 1])
        for k in batched:
            np.testing.assert_array_equal(batched[k][i], single[k][0])


def _jax_unfused_trunk(x, p, n_blocks):
    """deepliif_tpu/nets/resnet.py apply's unfused resblock loop (zero
    padding)."""
    from deepliif_tpu.nets import layers as L_jax
    for i in range(n_blocks):
        h = L_jax.conv2d(x, p[f'res{i}_conv1'], 1, 1)
        h = L_jax.relu(L_jax.apply_norm(h, p[f'res{i}_norm1'], 'batch', False))
        h = L_jax.conv2d(h, p[f'res{i}_conv2'], 1, 1)
        x = x + L_jax.apply_norm(h, p[f'res{i}_norm2'], 'batch', False)
    return x


@pytest.mark.parametrize('case', ['past_fused_gate', 'partial_scales'])
def test_unfused_int8_trunk_matches_jax(tmp_path, monkeypatch, case):
    """The two cases that take the JAX package's unfused int8 trunk at
    scope 'resblocks' (ngf 32, trunk 128 wide): 96^2 tiles put a 24 x 24
    trunk past the fused kernel's H % 16 (dynamic scales), and an
    act_scales.json for 3 of the 4 resblock convs (64^2 tiles; the scales
    the port calibrates on them; the fourth conv quantizes per sample).
    Translator 0's trunk on the same bf16 trunk input is bit-equal to the
    JAX package's unfused loop, and the session runs end to end."""
    md = write_model_dir(tmp_path)
    monkeypatch.setenv('DEEPLIIF_INT8_SCOPE', 'resblocks')
    monkeypatch.setenv('DEEPLIIF_INT8_CALIBRATE', '0')
    if case == 'past_fused_gate':
        size, mode = 96, 'dynamic'
    else:
        size, mode = 64, 'unfused'
        scales = M.InferenceSession(md, device='cpu', precision='int8') \
            .calibrate_int8(_tiles(2, size), save=False)
        with open(os.path.join(md, 'act_scales.json'), 'w') as f:
            json.dump({'scales': {k: scales[k] for k in (
                'G/res0_conv1', 'G/res0_conv2', 'G/res1_conv1')}}, f)
    p = jax.tree_util.tree_map(
        lambda a: a[0], M_jax.InferenceSession(md, precision='int8')
        .params['G'])
    sess = M.InferenceSession(md, device='cpu', precision='int8',
                              int8_scope='resblocks', int8_calibrate=False)
    net = sess.nets.G[0]
    assert net.int8_mode == mode
    trunk = size // 4
    h = np.random.default_rng(3).normal(0, 1, (2, trunk, trunk, 128))
    h = jax.numpy.asarray(np.maximum(h, 0), jax.numpy.bfloat16)
    with jax.disable_jit():
        ref = np.asarray(_jax_unfused_trunk(h, p, 2).astype(
            jax.numpy.float32))
    with torch.no_grad():
        got = net.trunk(torch.from_numpy(np.array(h.astype(
            jax.numpy.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), ref)
    out = sess.run_tiles(_tiles(2, size, seed=4))
    assert {k: v.shape for k, v in out.items()} == {
        k: (2, size, size, 3) for k in ('G1', 'G2', 'GS')}


def test_cli_int8_default_scope(base_dir, tmp_path, monkeypatch):
    """``--precision int8`` with no scope runs scope 'all' and writes
    act_scales.json; a model dir that cannot be written keeps the scales
    for the session; ``DEEPLIIF_INT8_CALIBRATE=0`` runs dynamic scales and
    writes nothing; a JAX kernel switch off its default raises."""
    inp = tmp_path / 'in'
    inp.mkdir()
    Image.fromarray(_tiles(1, 128, seed=2)[0]).save(inp / 'sample.png')

    def run(md, out):
        cli.run_test(str(inp), str(tmp_path / out), 128, md, device='cpu',
                     precision='int8', echo=lambda *a: None)
        names = sorted(os.listdir(tmp_path / out))
        assert 'sample.json' in names and len(names) == 6, names
        return M.init_nets(md, precision='int8', device='cpu',
                           **cli.int8_options(os.environ, 'int8'))

    md = _copy(base_dir, tmp_path / 'writable')
    sess = run(md, 'a')
    assert sess.int8_scope == 'all' and sess.act_scales
    with open(os.path.join(md, 'act_scales.json')) as f:
        assert set(json.load(f)['scales']) == set(sess.act_scales)

    def refuse(*a, **k):
        raise PermissionError('read-only model dir')
    md = _copy(base_dir, tmp_path / 'read_only')
    monkeypatch.setattr(quant, 'open', refuse, raising=False)
    sess = run(md, 'b')
    monkeypatch.undo()
    assert sess.act_scales and sess.nets.G[0].int8_mode == 'static'
    assert not os.path.exists(os.path.join(md, 'act_scales.json'))

    md = _copy(base_dir, tmp_path / 'dynamic')
    monkeypatch.setenv('DEEPLIIF_INT8_CALIBRATE', '0')
    sess = run(md, 'c')
    assert sess.act_scales is None and sess.nets.G[0].int8_mode == 'dynamic'
    assert not os.path.exists(os.path.join(md, 'act_scales.json'))

    monkeypatch.setenv('DEEPLIIF_FUSED_INT8', '0')
    with pytest.raises(NotImplementedError, match=roadmap.INT8_ALL):
        run(md, 'd')
    assert cli.int8_options({'DEEPLIIF_FUSED_INT8': '0'}, 'bfloat16') == \
        {'int8_calibrate': True, 'int8_calib_pct': 100.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
def test_cuda_int8_all_session_batch_invariant(cuda, base_dir, tmp_path,
                                               static):
    """On the card: a tile alone gives the bytes it gives in a batch, and
    two runs are byte-equal; every quantized conv outside the trunk
    launches conv_s8 (ngf 16: the trunk too, unfused)."""
    from deepliif_tpu_torch.ops import conv_int8
    md = _copy(base_dir, tmp_path / 'card')
    sess = M.InferenceSession(md, device='cuda', precision='int8',
                              max_batch=4, int8_calibrate=static)
    tiles = _tiles(4, 64, seed=9)
    sess.run_tiles(tiles[:1])
    n0 = conv_int8.conv_s8.launches
    batched = sess.run_tiles(tiles)
    # per translator 2 down, 4 trunk, 2 up convs; per unet_32 8 convs
    assert conv_int8.conv_s8.launches - n0 == 2 * 8 + 3 * 8
    again = sess.run_tiles(tiles)
    for k in batched:
        np.testing.assert_array_equal(batched[k], again[k])
    single = sess.run_tiles(tiles[2:3])
    for k in batched:
        np.testing.assert_array_equal(batched[k][2], single[k][0])
