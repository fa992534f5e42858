"""The fused translator stages of the port (bfloat16, ``fuse_stages``)
against the JAX package's (``DEEPLIIF_FUSE_STAGES=1``), on the CPU, and the
fixed-order norm statistics. Inputs are made with numpy from a seed and
handed to both; the JAX stage kernels run in Pallas interpret mode.

- (a) The plain versions of ``conv3x3_s2_stats`` (2, 64, 64, 16 -> 32) and
  ``convtranspose3_s2_stats`` (2, 32, 32, 16 -> 12) against the JAX
  kernels, with and without the input affine, at float32 and bfloat16: y
  within 1e-4 at float32 (the JAX package's own tolerance,
  tests/test_fused_stages.py) and within one bf16 ulp at bfloat16 (both
  round a float32 sum of the same exact products, taken in another order);
  stats within 1e-5 of the largest stat of their kind (float32 sums in
  another order; the JAX up kernel also sums per column phase).
- (b) A ResnetGenerator (ngf 32, 2 blocks, 64^2 input, both paddings)
  through the port's fused stages against ``resnet.apply(...,
  allow_fused=True, dtype=bfloat16)`` with ``DEEPLIIF_FUSE_STAGES=1`` and
  ``DEEPLIIF_FUSED=1``, on the same JAX params; spies show that both sides
  ran both stage functions and that the port ended in its tail kernel
  (``tail_s2d_fused``, once per translator), where the JAX fused path ends
  in XLA's tail conv (deepliif_tpu/nets/resnet.py ``_apply_fused``) and so
  calls its ``tail_s2d_fused`` never. The JAX side runs eagerly
  (``jax.disable_jit()``): eagerly every bf16 op rounds to bf16, the
  semantics the port implements (tests/test_torch_port_precision_slice.py).
  The JAX test of this path (tests/test_fused_stages.py) feeds float32 and
  so never reaches it. Bounds on the uint8 outputs (the engine's truncating
  cast): mean |d| <= 0.5 LSB and >= 99 % of pixels within 2 LSB, the bf16
  bounds of the precision slice.
- (c) A tiny model dir through ``InferenceSession(precision='bfloat16',
  fuse_stages=True)`` against the JAX session with the same environment:
  the same bounds.
- (d) The gate raises: float32, int8, a refused shape, a U-Net translator.
- (e) ``plane_sums``, ``plane_mean_var_reference`` and
  ``batch_stat_norm`` against the JAX package's two-pass per-sample norm (deepliif_tpu/nets/layers.py
  batch_stat_norm): statistics within 1e-6 relative, outputs within 1e-5
  at float32 and one bf16 ulp at bfloat16; per-sample statistics
  independent of the batch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu import models as M_jax
from deepliif_tpu.labs import fused_stages as FS_jax
from deepliif_tpu.nets import layers as L_jax, resnet as resnet_jax
from deepliif_tpu_torch import models as M
from deepliif_tpu_torch.labs import fused_stages as FS
from deepliif_tpu_torch.nets import layers as L
from deepliif_tpu_torch.nets.resnet import ResnetGenerator
from deepliif_tpu_torch.utils import checkpoints as ck
from test_torch_port_precision import write_model_dir

BF16_ULP = 2.0 ** -7
STATS_REL = 1e-5
F32_TOL = 1e-4
U8_MEAN, U8_WITHIN_2 = 0.5, 0.99


def _cast(a, dtype):
    """numpy float32 -> (torch tensor, jax array) holding the same values
    in ``dtype`` ('float32' or 'bfloat16')."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return (torch.from_numpy(np.array(j.astype(jnp.float32)))
            .to(getattr(torch, dtype)), j)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _stats_rel(got, ref):
    return max(float(np.abs(got[:, q] - ref[:, q]).max()
                     / np.abs(ref[:, q]).max()) for q in range(2))


def _u8(y):
    """tanh range -> uint8 as the engines quantize (truncating cast)."""
    return ((np.asarray(y, np.float32) + 1.0) * 127.5).astype(np.uint8)


def _assert_u8_close(a, b):
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    assert d.mean() <= U8_MEAN, d.mean()
    assert (d <= 2).mean() >= U8_WITHIN_2, (d <= 2).mean()


STAGES = {'conv3x3_s2_stats': ((2, 64, 64, 16), 32),
          'convtranspose3_s2_stats': ((2, 32, 32, 16), 12)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine_relu'])
@pytest.mark.parametrize('name', sorted(STAGES))
def test_stage_plain_versions_match_jax(name, affine, dtype):
    rng = np.random.default_rng(0)
    shape, cout = STAGES[name]
    s, cin = shape[0], shape[3]
    xt, xj = _cast(rng.normal(0, 1, shape).astype(np.float32), dtype)
    wt, wj = _cast(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32),
                   dtype)
    sc = (1 + 0.1 * rng.normal(0, 1, (s, cin))).astype(np.float32)
    bi = (0.1 * rng.normal(0, 1, (s, cin))).astype(np.float32)
    kw_j = dict(in_scale=jnp.asarray(sc), in_bias=jnp.asarray(bi),
                in_relu=True) if affine else {}
    kw_t = dict(in_scale=torch.from_numpy(sc), in_bias=torch.from_numpy(bi),
                in_relu=True) if affine else {}
    y_ref, st_ref = getattr(FS_jax, name)(xj, wj, chunk_rows=8,
                                          interpret=True, **kw_j)
    y, st = getattr(FS, name)(xt, wt, **kw_t)
    assert y.dtype == xt.dtype and y.shape == y_ref.shape
    y_ref = _np(y_ref)
    if dtype == 'float32':
        assert np.abs(_np(y) - y_ref).max() <= F32_TOL
    else:
        assert (np.abs(_np(y) - y_ref) <= BF16_ULP * np.abs(y_ref) + 1e-6).all()
    assert _stats_rel(st.numpy(), np.asarray(st_ref)) < STATS_REL


class _Spy:
    """Counts the calls of module attributes ``names`` of ``module``."""

    def __init__(self, monkeypatch, module, names):
        self.calls = {n: 0 for n in names}
        for n in names:
            fn = getattr(module, n)

            def wrapped(*a, _fn=fn, _n=n, **k):
                self.calls[_n] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(module, n, wrapped)


STAGE_FNS = ('conv3x3_s2_stats', 'convtranspose3_s2_stats')
SPIED = STAGE_FNS + ('tail_s2d_fused',)


def _calls(stage, tail):
    return {**{n: stage for n in STAGE_FNS}, 'tail_s2d_fused': tail}


@pytest.fixture
def jax_fuse_stages(monkeypatch):
    monkeypatch.setenv('DEEPLIIF_FUSE_STAGES', '1')
    monkeypatch.setenv('DEEPLIIF_FUSED', '1')
    monkeypatch.setenv('DEEPLIIF_INFER_DEVICES', '1')
    return (_Spy(monkeypatch, FS_jax, SPIED),
            _Spy(monkeypatch, FS, SPIED))


@pytest.mark.parametrize('padding', ['zero', 'reflect'])
def test_fused_translator_matches_jax(padding, jax_fuse_stages):
    spy_jax, spy_port = jax_fuse_stages
    p = resnet_jax.init(jax.random.PRNGKey(0), 3, 3, ngf=32, n_blocks=2,
                        padding_type=padding)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    with jax.disable_jit():
        ref = resnet_jax.apply(p, jnp.asarray(x), n_blocks=2,
                               padding_type=padding, train=False,
                               allow_fused=True, dtype=jnp.bfloat16)
    net = ResnetGenerator(3, 3, 32, 2, padding_type=padding).eval()
    net.load_state_dict(ck.params_from_jax(
        net, jax.tree_util.tree_map(np.asarray, p)))
    net.compute_dtype, net.fuse_stages = torch.bfloat16, True
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    # the JAX fused path ends in XLA's tail conv: its tail kernel runs 0 times
    assert spy_jax.calls == _calls(2, 0)
    assert spy_port.calls == _calls(2, 1)
    assert got.dtype == torch.bfloat16
    _assert_u8_close(_u8(got.float().permute(0, 2, 3, 1).numpy()),
                     _u8(_np(ref)))


def test_fused_stage_session_matches_jax(tmp_path, jax_fuse_stages):
    """Two translators and three seg nets, two 64^2 tiles, run_tiles."""
    spy_jax, spy_port = jax_fuse_stages
    md = write_model_dir(tmp_path)
    tiles = np.random.default_rng(5).integers(0, 255, (2, 64, 64, 3),
                                              np.uint8)
    with jax.disable_jit():
        ref = M_jax.InferenceSession(md, n_devices=1,
                                     precision='bfloat16').run_tiles(tiles)
    sess = M.InferenceSession(md, device='cpu', precision='bfloat16',
                              fuse_stages=True)
    assert sess.d.fuse_stages and all(g.fuse_stages for g in sess.nets.G)
    got = sess.run_tiles(tiles)
    # two translators, two calls of each stage function and (the port
    # only: the JAX fused path ends in XLA's tail conv) one of the tail
    # kernel per translator
    assert spy_jax.calls == _calls(4, 0)
    assert spy_port.calls == _calls(4, 2)
    assert set(got) == set(ref) == {'G1', 'G2', 'GS'}
    for k in ref:
        _assert_u8_close(got[k], ref[k])


def test_fuse_stages_gate_raises(tmp_path):
    md = write_model_dir(tmp_path)
    with pytest.raises(ValueError, match='bfloat16 only'):
        M.InferenceSession(md, device='cpu', precision='float32',
                           fuse_stages=True)
    with pytest.raises(ValueError, match='int8 trunk without a word'):
        M.InferenceSession(md, device='cpu', precision='int8',
                           int8_scope='resblocks', fuse_stages=True)
    sess = M.InferenceSession(md, device='cpu', precision='bfloat16',
                              fuse_stages=True)
    tiles = np.random.default_rng(0).integers(0, 255, (1, 48, 48, 3), np.uint8)
    with pytest.raises(ValueError, match='H, W % 16'):
        sess.run_tiles(tiles)
    with pytest.raises(ValueError, match='C % 128'):
        net = ResnetGenerator(3, 3, 16, 2).eval()
        net.compute_dtype, net.fuse_stages = torch.bfloat16, True
        net(torch.zeros((1, 3, 64, 64)))
    from deepliif_tpu_torch.models import deepliif as dl
    with pytest.raises(ValueError, match='ResNet translators'):
        dl.DeepLIIFNets(dl.DeepLIIFDef(net_g=('unet_32',) * 4,
                                       dtype=torch.bfloat16,
                                       fuse_stages=True))


def test_cli_fuse_stages_option(tmp_path, monkeypatch):
    from click.testing import CliRunner
    from PIL import Image
    from deepliif_tpu_torch import cli

    spy = _Spy(monkeypatch, FS, SPIED)
    (tmp_path / 'model').mkdir()
    md = write_model_dir(tmp_path / 'model')
    inp = tmp_path / 'in'
    inp.mkdir()
    Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (128, 128, 3), np.uint8)).save(inp / 'sample.png')
    res = CliRunner().invoke(cli.make_cli(), [
        'test', '--input-dir', str(inp), '--output-dir', str(tmp_path / 'out'),
        '--tile-size', '128', '--model-dir', md, '--device', 'cpu',
        '--precision', 'bfloat16', '--fuse-stages'])
    assert res.exit_code == 0, res.output
    assert spy.calls == _calls(4, 2)                   # 2 translators
    names = sorted(p.name for p in (tmp_path / 'out').iterdir())
    assert 'sample.json' in names and len(names) == 6, names


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_norm_statistics_match_two_pass_formula(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, (3, 40, 48, 24)).astype(np.float32)   # NHWC
    xt, xj = _cast(x, dtype)
    xt = xt.permute(0, 3, 1, 2)                   # NCHW, channels_last memory
    scale = (1 + 0.1 * rng.normal(0, 1, 24)).astype(np.float32)
    bias = (0.1 * rng.normal(0, 1, 24)).astype(np.float32)

    # the statistics against the two-pass formula in float64
    x64 = _np(xj).astype(np.float64)
    mean64 = x64.mean(axis=(1, 2))
    st = L.plane_sums(xt).numpy()
    np.testing.assert_allclose(st[:, 0] / (40 * 48), mean64, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st[:, 1], (x64 ** 2).sum(axis=(1, 2)),
                               rtol=1e-6)
    mv = L.plane_mean_var_reference(xt).numpy()
    np.testing.assert_allclose(mv[:, 0], mean64, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        mv[:, 1], ((x64 - mean64[:, None, None]) ** 2).mean(axis=(1, 2)),
        rtol=1e-6)

    # the whole norm against the JAX package's per-sample norm
    got = _np(L.batch_stat_norm(xt, torch.from_numpy(scale),
                                torch.from_numpy(bias)).permute(0, 2, 3, 1))
    ref = _np(L_jax.batch_stat_norm(xj, {'scale': jnp.asarray(scale),
                                         'bias': jnp.asarray(bias)},
                                    per_sample=True))
    if dtype == 'float32':
        assert np.abs(got - ref).max() <= 1e-5
    else:
        # scale and bias round to bf16 and so do the product and the sum:
        # a float32 statistic one ulp apart can move a value by one ulp
        assert (np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-6).all()

    # per-sample statistics do not depend on the batch
    for i in range(3):
        one = L.plane_sums(xt[i:i + 1])
        assert torch.equal(one[0], L.plane_sums(xt)[i])
        one = L.plane_mean_var_reference(xt[i:i + 1])
        assert torch.equal(one[0], L.plane_mean_var_reference(xt)[i])


# ---- the stride-2 tensor-core kernel (csrc/conv3x3_wgmma.cuh) against its
# plain version at ragged shapes: output H, W not multiples of its 16 x 16
# tile, Cin and Cout multiples of 8 but not of its 16-channel stage or
# 128-channel block. y within one bf16 ulp, stats within STATS_REL
# (chip_smoke.py STAGE_STATS_TOL), and a sample byte-equal alone and in the
# batch, run to run.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine_relu'])
@pytest.mark.parametrize('shape,cout', [((2, 38, 46, 40), 56),
                                        ((2, 18, 130, 72), 24)])
def test_cuda_conv3x3_s2_kernel_matches_plain_version(cuda, shape, cout,
                                                      affine):
    rng = np.random.default_rng(4)
    s, cin = shape[0], shape[3]
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.05, (3, 3, cin, cout))
                         .astype(np.float32))
    x, w = x.cuda().to(torch.bfloat16), w.cuda().to(torch.bfloat16)
    kw = {}
    if affine:
        kw = dict(in_scale=torch.from_numpy(
                      (1 + 0.1 * rng.normal(0, 1, (s, cin))).astype(np.float32)
                  ).cuda(),
                  in_bias=torch.from_numpy(
                      (0.1 * rng.normal(0, 1, (s, cin))).astype(np.float32)
                  ).cuda(), in_relu=True)
    n0 = FS.conv3x3_s2_stats.launches
    y, st = FS.conv3x3_s2_stats(x, w, **kw)
    assert FS.conv3x3_s2_stats.launches == n0 + 1
    y_ref, st_ref = FS.conv3x3_s2_stats_reference(x, w, **kw)
    d = (y.float() - y_ref.float()).abs()
    assert bool((d <= BF16_ULP * y_ref.float().abs() + 1e-6).all())
    assert _stats_rel(st.cpu().numpy(), st_ref.cpu().numpy()) < STATS_REL
    y2, st2 = FS.conv3x3_s2_stats(x, w, **kw)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    alone = {k: (v[1:2].contiguous() if isinstance(v, torch.Tensor) else v)
             for k, v in kw.items()}
    y1, st1 = FS.conv3x3_s2_stats(x[1:2].contiguous(), w, **alone)
    assert torch.equal(y1[0], y[1]) and torch.equal(st1[0], st[1])


# ---- the conv-transpose tensor-core kernel (csrc/conv3x3_wgmma.cuh, CONVT)
# against its plain version at ragged shapes: input H, W not multiples of
# its 16 x 16 tile, Cin and Cout multiples of 8 but not of its 16-channel
# stage or 64-channel block (136: three blocks, the last one masked). y
# within one bf16 ulp, stats within STATS_REL (chip_smoke.py
# STAGE_STATS_TOL), and a sample byte-equal alone and in the batch, run to
# run.

@pytest.mark.cuda
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine_relu'])
@pytest.mark.parametrize('shape,cout', [((2, 37, 45, 40), 56),
                                        ((2, 19, 66, 72), 24),
                                        ((2, 21, 34, 32), 136)])
def test_cuda_convtranspose3_s2_kernel_matches_plain_version(cuda, shape,
                                                             cout, affine):
    rng = np.random.default_rng(5)
    s, cin = shape[0], shape[3]
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.05, (3, 3, cin, cout))
                         .astype(np.float32))
    x, w = x.cuda().to(torch.bfloat16), w.cuda().to(torch.bfloat16)
    kw = {}
    if affine:
        kw = dict(in_scale=torch.from_numpy(
                      (1 + 0.1 * rng.normal(0, 1, (s, cin))).astype(np.float32)
                  ).cuda(),
                  in_bias=torch.from_numpy(
                      (0.1 * rng.normal(0, 1, (s, cin))).astype(np.float32)
                  ).cuda(), in_relu=True)
    n0 = FS.convtranspose3_s2_stats.launches
    y, st = FS.convtranspose3_s2_stats(x, w, **kw)
    assert FS.convtranspose3_s2_stats.launches == n0 + 1
    assert y.shape == (s, 2 * shape[1], 2 * shape[2], cout)
    y_ref, st_ref = FS.convtranspose3_s2_stats_reference(x, w, **kw)
    d = (y.float() - y_ref.float()).abs()
    assert bool((d <= BF16_ULP * y_ref.float().abs() + 1e-6).all())
    assert _stats_rel(st.cpu().numpy(), st_ref.cpu().numpy()) < STATS_REL
    y2, st2 = FS.convtranspose3_s2_stats(x, w, **kw)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    alone = {k: (v[1:2].contiguous() if isinstance(v, torch.Tensor) else v)
             for k, v in kw.items()}
    y1, st1 = FS.convtranspose3_s2_stats(x[1:2].contiguous(), w, **alone)
    assert torch.equal(y1[0], y[1]) and torch.equal(st1[0], st[1])


# ---- the phase split of that kernel, on the CPU: its packed weight image
# holds the HWIO taps phase by phase (csrc/conv3x3_wgmma.cuh convt_first /
# image_tap: positions 0 | 1-2 | 3-4 | 5-8 hold taps 4 | 3 5 | 1 7 | 0 2 6 8)
# and output phase (a, b) = (ph // 2, ph % 2) sums its taps (ky, kx) over
# the input shifted by (ky == 2, kx == 2), zero past the bottom and right
# edge. Assembled in torch, the four phase convs must be
# ConvTranspose2d(3, 2, 1, output_padding=1): equal to F.conv_transpose2d
# in float64 (within 1e-12) and to JAX's convtranspose3_s2_stats in Pallas
# interpret mode at float32 (within 1e-4, its own tolerance).

CONVT_IMAGE_TAPS = (4, 3, 5, 1, 7, 0, 2, 6, 8)
CONVT_PHASE_FIRST = (0, 1, 3, 5, 9)


def convtranspose_from_phases(x, w):
    """NHWC x, HWIO forward-conv w -> the conv-transpose from the kernel's
    four phase convs."""
    s, h, wd, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 0, 1, 0, 1))
    y = x.new_zeros((s, 2 * h, 2 * wd, w.shape[3]))
    for ph in range(4):
        taps = CONVT_IMAGE_TAPS[CONVT_PHASE_FIRST[ph]:CONVT_PHASE_FIRST[ph + 1]]
        acc = 0
        for tap in taps:
            ky, kx = divmod(tap, 3)
            dy, dx = int(ky == 2), int(kx == 2)
            acc = acc + xp[:, dy:dy + h, dx:dx + wd] @ w[ky, kx]
        y[:, ph // 2::2, ph % 2::2] = acc
    return y


@pytest.mark.parametrize('shape,cout', [((2, 8, 11, 16), 24),
                                        ((1, 16, 10, 8), 8)])
def test_convtranspose_phase_split_matches_torch_and_jax(shape, cout):
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, shape)
    w = rng.normal(0, 0.1, (3, 3, shape[3], cout))
    got = convtranspose_from_phases(torch.from_numpy(x), torch.from_numpy(w))
    want = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        ck.weight_from_hwio(torch.from_numpy(w), 'convT'), stride=2,
        padding=1, output_padding=1).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-12
    # every position of the image is a tap, once, and each phase takes the
    # taps of its parity
    assert sorted(CONVT_IMAGE_TAPS) == list(range(9))
    for ph in range(4):
        for tap in CONVT_IMAGE_TAPS[CONVT_PHASE_FIRST[ph]:
                                    CONVT_PHASE_FIRST[ph + 1]]:
            ky, kx = divmod(tap, 3)
            assert (ky == 1) == (ph // 2 == 0) and (kx == 1) == (ph % 2 == 0)
    y_jax, _ = FS_jax.convtranspose3_s2_stats(
        jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
        chunk_rows=8, interpret=True)
    got32 = convtranspose_from_phases(torch.from_numpy(x).float(),
                                      torch.from_numpy(w).float())
    assert np.abs(got32.numpy() - np.asarray(y_jax)).max() <= F32_TOL
