"""The model families other than DeepLIIF (DeepLIIFExt, SDG, CycleGAN)
through the port's engine, against the JAX package on the same tiny model
dirs (CPU): native dirs written by the JAX package (its param trees, with
numpy-seeded values at the reference init), and reference-layout
dirs of torch state dicts (``{epoch}_net_{group}_{i}.pth``) that both
packages import.

Tolerance: uint8 outputs within 1 LSB on fewer than 0.1 % of pixels (the
truncating float32 -> uint8 cast flips where the two frameworks' float32
results straddle an integer); cell counts equal."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from deepliif_tpu import cli as cli_jax, models as M_jax
from deepliif_tpu.models import cyclegan as cg_jax
from deepliif_tpu.models import deepliif_ext as ext_jax
from deepliif_tpu.models import sdg as sdg_jax
from deepliif_tpu.utils import checkpoints as ck_jax
from deepliif_tpu_torch import cli, models as M

BASE = {'seg_gen': False, 'seg_no': 0, 'input_no': 1,
        'netG': 'resnet_6blocks', 'ngf': 8, 'norm': 'batch',
        'no_dropout': False, 'padding': 'zero', 'scale_size': 64}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers (torch's per-op
    pool oversubscribes the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _init(init_params, d, seed):
    """The JAX family's param tree (its ``init_params`` structure, traced by
    ``jax.eval_shape``) with numpy-seeded values at the reference init:
    conv kernels N(0, 0.02), norm scales N(1, 0.02), biases 0 (the first
    ``jax.random`` call of a process costs seconds on the CPU)."""
    rng = np.random.default_rng(seed)
    like = jax.eval_shape(lambda k: init_params(k, d,
                                                with_discriminators=False),
                          jax.ShapeDtypeStruct((2,), np.uint32))

    def leaf(path, a):
        name = str(getattr(path[-1], 'key', ''))
        if name == 'w':
            return rng.normal(0, 0.02, a.shape).astype(np.float32)
        if name == 'scale':
            return (1 + rng.normal(0, 0.02, a.shape)).astype(np.float32)
        return np.zeros(a.shape, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, like)


def _write(md, params, cfg):
    os.makedirs(md, exist_ok=True)
    ck_jax.save_networks(md, params)
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    return md


def _reference_dir(native, out, groups=None):
    """The nets of the native dir ``native`` as a reference-layout dir:
    one ``latest_net_{group}_{i}.pth`` state dict per net (the port's
    modules hold the reference layout)."""
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(native, 'config.json'), out)
    sess = M.InferenceSession(native, device='cpu')
    for name, group in sess.nets.named_groups():
        if groups is None or name in groups:
            for i, net in enumerate(group):
                torch.save(net.state_dict(),
                           os.path.join(out, f'latest_net_{name}_{i + 1}.pth'))
    return out


def _ext_cfg():
    return dict(BASE, model='DeepLIIFExt', modalities_no=2, seg_gen=True,
                seg_no=2, net_gs='unet_32', seg_weights=[0.5, 0.5],
                modalities_names=['mod0', 'mod1', 'mod2'])


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('families'))
    out = {}
    d = ext_jax.DeepLIIFExtDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                               net_gs=('unet_32',) * 2, ngf=8, ndf=8,
                               loss_g_weights=(0.5, 0.5),
                               loss_d_weights=(0.5, 0.5))
    out['ext'] = _write(os.path.join(root, 'ext'),
                        _init(ext_jax.init_params, d, 3), _ext_cfg())
    d = sdg_jax.SDGDef(modalities_no=2, input_no=2,
                       net_g=('resnet_6blocks',) * 2, ngf=8,
                       loss_g_weights=(0.5, 0.5), loss_d_weights=(0.5, 0.5))
    out['sdg'] = _write(os.path.join(root, 'sdg'),
                        _init(sdg_jax.init_params, d, 4),
        dict(BASE, model='SDG', modalities_no=2, input_no=2,
             modalities_names=['in1', 'in2', 'm1', 'm2']))
    d = cg_jax.CycleGANDef(modalities_no=1, net_g=('resnet_6blocks',), ngf=8,
                           loss_g_weights=(1.0,), loss_d_weights=(1.0,))
    params = _init(cg_jax.init_params, d, 5)
    for bto_a in (False, True):
        out[f'cg{int(bto_a)}'] = _write(
            os.path.join(root, f'cg{int(bto_a)}'), params,
            dict(BASE, model='CycleGAN', modalities_no=1, BtoA=bto_a,
                 modalities_names=['m0', 'm1']))
    for name in ('ext', 'sdg'):
        out[f'{name}_ref'] = _reference_dir(out[name],
                                            os.path.join(root, f'{name}_ref'))
    # one direction only: GA natively, GB as reference files
    out['ga_only'] = _write(os.path.join(root, 'ga_only'),
                            {'GA': params['GA']},
                            dict(BASE, model='CycleGAN', modalities_no=1,
                                 modalities_names=['m0', 'm1']))
    out['gb_only_ref'] = _reference_dir(
        out['cg1'], os.path.join(root, 'gb_only_ref'), groups=('GB',))
    return out


def _compare(ref, got):
    (ref_images, ref_scoring), (images, scoring) = ref, got
    assert set(images) == set(ref_images)
    for k in ref_images:
        assert images[k].size == ref_images[k].size
        _assert_u8_close(images[k], ref_images[k])
    assert scoring == ref_scoring


@pytest.mark.parametrize('layout', ['ext', 'ext_ref'])
def test_ext_infer_modalities_matches_jax(dirs, layout):
    img = _img(100, 80)
    ref = M_jax.infer_modalities(img, 64, dirs[layout])
    got = M.infer_modalities(img, 64, dirs[layout], device='cpu')
    _compare(ref, got)
    images, scoring = got
    assert {'mod1', 'mod2', 'Seg1', 'Seg2', 'Seg1_Overlaid', 'Seg2_Refined'} \
        <= set(images)
    assert 'num_total' in scoring['Seg1']


@pytest.mark.parametrize('layout', ['sdg', 'sdg_ref'])
def test_sdg_infer_modalities_matches_jax(dirs, layout):
    """Two input modalities side by side (width 2 x 64), split into strips
    and concatenated by channel."""
    wide = Image.fromarray(np.concatenate(
        [np.asarray(_img(64, 64, 1)), np.asarray(_img(64, 64, 2))], axis=1))
    ref = M_jax.infer_modalities(wide, 64, dirs[layout])
    got = M.infer_modalities(wide, 64, dirs[layout], device='cpu')
    _compare(ref, got)
    assert set(got[0]) == {'mod1', 'mod2'} and got[1] is None


@pytest.mark.parametrize('layout', ['cg0', 'cg1', 'ga_only', 'gb_only_ref'])
def test_cyclegan_inference_matches_jax(dirs, layout):
    """GA, GB (the dir's BtoA option), a native dir of GA alone and a
    reference dir of GB alone."""
    img = _img(96, 64, seed=3)
    kw = dict(tile_size=64, overlap_size=4, model_path=dirs[layout])
    ref = M_jax.inference(img, **kw)
    got = M.inference(img, device='cpu', **kw)
    want = 'GB_1' if layout in ('cg1', 'gb_only_ref') else 'GA_1'
    assert set(got) == set(ref) == {want}
    _assert_u8_close(got[want], ref[want])


def test_cyclegan_missing_direction_raises(dirs):
    sess = M.InferenceSession(dirs['ga_only'], device='cpu')
    assert sess.nets.groups == ('GA',)
    sess.opt.BtoA = True
    with pytest.raises(FileNotFoundError, match='GB'):
        sess.run_tiles(np.asarray(_img(64, 64))[None])


@pytest.mark.parametrize('precision', ['bfloat16', 'int8'])
@pytest.mark.parametrize('family', ['ext', 'sdg', 'cg0'])
def test_family_sessions_compute_in_float32(dirs, family, precision):
    """The JAX family definitions take no dtype from ``precision``: a
    session at any precision computes in float32, byte-equal to the
    float32 session."""
    sess = M.InferenceSession(dirs[family], device='cpu', precision=precision)
    f32 = M.InferenceSession(dirs[family], device='cpu')
    assert sess.precision == precision
    assert sess.d.dtype == torch.float32 and not sess.d.quant_int8
    assert all(p.dtype == torch.float32 for p in sess.nets.parameters())
    c = 6 if family == 'sdg' else 3
    tiles = np.random.default_rng(7).integers(0, 255, (2, 64, 64, c),
                                              np.uint8)
    got, want = sess.run_tiles(tiles), f32.run_tiles(tiles)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_family_session_refuses_fuse_stages(dirs):
    with pytest.raises(ValueError, match='float32'):
        M.InferenceSession(dirs['ext'], device='cpu', fuse_stages=True)


def test_ext_batch_invariance_and_empty_tiles(dirs):
    """A tile's outputs do not depend on its batch; an empty tile gets the
    background colors and a zero seg."""
    sess = M.InferenceSession(dirs['ext'], device='cpu')
    tiles = np.random.default_rng(8).integers(0, 255, (3, 64, 64, 3),
                                              np.uint8)
    tiles[1] = 230
    out = sess.run_tiles(tiles)
    assert set(out) == {'G_1', 'G_2', 'GS_1', 'GS_2'}
    assert (out['G_1'][1] == 10).all() and not out['GS_2'][1].any()
    for i in (0, 2):
        alone = sess.run_tiles(tiles[i:i + 1])
        for k in out:
            np.testing.assert_array_equal(out[k][i], alone[k][0])


def test_ext_cli_writes_same_files_as_jax_cli(dirs, tmp_path):
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
            '--tile-size', '64', '--model-dir', dirs['ext'], *extra])
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


def test_postprocess_resolution_rule_of_ext_and_sdg(dirs):
    """Ext / SDG score at 10x up to 384 px tiles, 20x up to 768, 40x past
    it (the JAX package's rule for these families); CycleGAN has no
    postprocess, as in the JAX package."""
    import deepliif_tpu_torch.postprocessing as pp
    seen = []
    real = pp.compute_final_results

    def spy(orig, seg, marker, resolution, *a):
        seen.append(resolution)
        return real(orig, seg, marker, resolution, *a)
    orig = np.asarray(_img(32, 32))
    seg = Image.fromarray(np.zeros((32, 32, 3), np.uint8))
    pp.compute_final_results = spy
    try:
        for ts in (384, 385, 768, 769):
            M.postprocess(orig, {'Seg1': seg}, ts, 'DeepLIIFExt')
    finally:
        pp.compute_final_results = real
    assert seen == ['10x', '20x', '20x', '40x']
    with pytest.raises(NotImplementedError, match='CycleGAN'):
        M.postprocess(orig, {}, 64, 'CycleGAN')


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
@pytest.mark.parametrize('family', ['ext', 'sdg', 'cg0'])
def test_cuda_family_launches_and_determinism(cuda, dirs, family):
    """On the card: the translators' trunk on the float32 trunk kernel
    (6 blocks x 2 convs per translator), every norm on the statistics
    kernel with no input copied, in one batch forward (after the call
    that probed its bucket), outputs byte-equal run to run and for a
    tile alone."""
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.ops import fused_resblock as FR
    sess = M.InferenceSession(dirs[family], device='cuda')
    c = 6 if family == 'sdg' else 3
    tiles = np.random.default_rng(9).integers(0, 255, (3, 64, 64, c),
                                              np.uint8)
    sess.run_tiles(tiles)         # the bucket's probe runs once, here
    t0, p0 = FR.conv3x3_stats.launches, L.plane_mean_var.launches
    r0 = L.plane_mean_var.relayouts
    out = sess.run_tiles(tiles)
    m = sess.d.modalities_no
    assert FR.conv3x3_stats.launches - t0 == m * 12
    segs = m if family == 'ext' else 0
    assert L.plane_mean_var.launches - p0 == m * 5 + segs * 7
    assert L.plane_mean_var.relayouts == r0
    again, alone = sess.run_tiles(tiles), sess.run_tiles(tiles[1:2])
    for k in out:
        np.testing.assert_array_equal(out[k], again[k])
        np.testing.assert_array_equal(out[k][1], alone[k][0])
