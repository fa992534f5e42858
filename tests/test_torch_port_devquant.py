"""The port's device quantifier (``deepliif_tpu_torch.ops.labeling``), the
device-side seg stitch and the ``device_quant`` pipeline against the JAX
package, on the CPU: the same numpy inputs through both.

On a CPU tensor ``label_components`` runs its plain version
(``label_components_reference``); the CUDA kernel ``csrc/label_cc.cu`` is
held to that plain version on the card by ``chip_smoke.py``. The JAX side
runs its XLA labeling and its Pallas labeling kernel in interpret mode.

Tolerance: none. Labels, masks, statistics and thresholds are integers and
equal; overlay and refined images are byte-equal; scoring dicts are equal;
counts equal the host quantifier's. The KDE size threshold sums float32
terms in another order than XLA; it agrees on every canvas here."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deepliif_tpu import models as M_jax
from deepliif_tpu.ops import labeling as LJ
from deepliif_tpu_torch import models as M, postprocessing as pp
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.ops import labeling as LT
from deepliif_tpu_torch.utils import checkpoints as ck
from deepliif_tpu_torch.utils.tiler import InferenceTiler
from test_inference import TINY_CFG
from test_torch_port_host import _seg_canvas


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Torch on one thread in this module: the quantifier's CPU path is
    many small whole-canvas ops, and beside the suite's other workers a
    thread pool per op is oversubscribed (a 256^2 quantifier call took
    20 s on 8 threads under load, 0.4 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the JAX functions jitted once per shape and static argument (eagerly,
# each call compiles its while loops anew)
_LABEL_XLA = jax.jit(LJ.label_components, static_argnames='conn8')
_LABEL_PALLAS = jax.jit(LJ.label_components_pallas,
                        static_argnames=('conn8', 'interpret'))


@pytest.mark.parametrize('conn8', [True, False], ids=['conn8', 'conn4'])
@pytest.mark.parametrize('shape,fill', [
    ((32, 64), 0.3), ((32, 64), 1.0), ((32, 64), 0.0), ((37, 29), 0.45)])
def test_label_components_match_jax(shape, fill, conn8):
    """The plain labeling against JAX's XLA labeling and its Pallas kernel
    (interpret mode): bit-equal canonical labels, non-square canvases, a
    full and an empty one."""
    fg = np.random.default_rng(int(fill * 100)).random(shape) < fill
    want = np.asarray(_LABEL_XLA(jnp.asarray(fg), conn8=conn8))
    pallas = np.asarray(_LABEL_PALLAS(jnp.asarray(fg), conn8=conn8,
                                      interpret=True))
    got = LT.label_components(_t(fg), conn8=conn8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert got.numpy().max() <= fg.size


def test_masks_stats_and_marker_max_match_jax():
    """posneg_mask, flood_background, the per-label statistics, the
    per-pixel component marker max and quantify, on a seg canvas with
    cells, against the JAX functions."""
    orig, seg, marker = _seg_canvas(size=256, seed=4)
    mask_j = jax.jit(lambda s: LJ.flood_background(LJ.posneg_mask(s, 120)))(
        jnp.asarray(seg))
    mask = LT.flood_background(LT.posneg_mask(_t(seg), 120))
    np.testing.assert_array_equal(
        LT.posneg_mask(_t(seg), 120).numpy(),
        np.asarray(LJ.posneg_mask(jnp.asarray(seg), 120)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))

    lab = LT.label_components(mask != pp.LABEL_BACKGROUND)
    flat = lab.reshape(-1)
    n = seg.shape[0] * seg.shape[1] + 1
    got = LT._segment_stats(flat, mask, n)
    want = LJ._segment_stats(jnp.asarray(flat.numpy()), mask_j, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[0][1:] > 4).sum()) > 20          # cells, not vacuous

    pixel = LT._component_marker_max(flat, _t(marker).reshape(-1), n)[flat]
    pixel_j, _ = jax.jit(LJ._component_marker_max)(
        jnp.asarray(flat.numpy()), jnp.asarray(marker.reshape(-1)))
    np.testing.assert_array_equal(pixel.numpy(), np.asarray(pixel_j))

    kw = dict(size_thresh=20, marker_thresh=150, large_noise_thresh=200,
              size_thresh_upper=300)
    q = LT.quantify(_t(seg), _t(marker), **kw)
    qj = jax.jit(lambda s, m: LJ.quantify(s, m, **kw))(jnp.asarray(seg),
                                                      jnp.asarray(marker))
    for k in ('num_pos', 'num_neg', 'num_total'):
        assert int(q[k]) == int(qj[k]), k
    assert 0 < int(q['num_pos']) < int(q['num_total'])
    np.testing.assert_array_equal(q['class_image'].numpy(),
                                  np.asarray(qj['class_image']))


def test_auto_thresholds_match_jax():
    """KDE size threshold on sizes tables below and above the 16384-entry
    compaction, at the three resolutions, and the marker threshold, as
    integers."""
    rng = np.random.default_rng(5)
    tables = []
    for n_cells, n in ((1, 4000), (40, 4000), (300, 70000), (20000, 70000)):
        sizes = np.zeros(n, np.int32)
        pos = rng.choice(n, n_cells, replace=False)
        # two populations: small debris and nuclei
        sizes[pos] = np.where(rng.random(n_cells) < 0.3,
                              rng.integers(5, 30, n_cells),
                              rng.integers(40, 400, n_cells))
        tables.append(sizes)
    for sizes, res in zip(tables, ('40x', '20x', '10x', '40x')):
        want = int(LJ.auto_size_threshold(jnp.asarray(sizes), res))
        assert int(LT.auto_size_threshold(_t(sizes), res)) == want
    for fill in (0.0, 0.3, 0.9):
        mk = rng.integers(0, 255, (120, 90)).astype(np.uint8)
        mk[rng.random(mk.shape) < fill] = 0
        if fill == 0.0:
            mk[:] = 0
        want = int(LJ.auto_marker_threshold(jnp.asarray(mk)))
        assert int(LT.auto_marker_threshold(_t(mk))) == want


def test_overlay_images_match_jax():
    rng = np.random.default_rng(6)
    cls = np.zeros((70, 90), np.uint8)
    for _ in range(25):
        y, x = rng.integers(0, 64, 2)
        cls[y:y + rng.integers(2, 7), x:x + rng.integers(2, 7)] = \
            rng.integers(1, 3)
    orig = rng.integers(0, 255, (70, 90, 3), np.uint8)
    want = LJ.overlay_images(jnp.asarray(orig), jnp.asarray(cls))
    got = LT.overlay_images(_t(orig), _t(cls))
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('size,marker,size_thresh,marker_thresh', [
    ((512, 512), False, 'default', None),
    ((512, 512), True, 30, 100),
    ((200, 330), True, None, 'default')],
    ids=['auto_size', 'static', 'unpadded_auto_marker'])
def test_compute_final_results_device_matches_jax(size, marker, size_thresh,
                                                  marker_thresh):
    """The whole device quantifier on the CPU against the JAX one (jitted on
    the CPU): overlay and refined byte-equal, scoring equal; counts equal to
    the port's host quantifier."""
    orig, seg, mk = _seg_canvas(size=512, seed=7)
    orig, seg, mk = (a[:size[0], :size[1]] for a in (orig, seg, mk))
    mk = mk if marker else None
    kw = dict(size_thresh=size_thresh, marker_thresh=marker_thresh)
    want = LJ.compute_final_results_device(orig, seg, mk, '40x', mesh=None,
                                           **kw)
    got = LT.compute_final_results_device(orig, seg, mk, '40x', device='cpu',
                                          **kw)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == orig.shape
    host = pp.compute_final_results(orig, seg, mk, '40x', **kw)[2]
    for k in ('num_total', 'num_pos', 'num_neg'):
        assert got[2][k] == host[k], (k, got[2], host)
    assert got[2]['num_total'] > 10 and 0 < got[2]['num_pos']


def test_device_quantifier_takes_a_tensor_canvas():
    """A seg canvas already on the device gives what its numpy copy gives,
    and the labeling function is the one passed in."""
    orig, seg, marker = _seg_canvas(size=256, seed=8)
    calls = []

    def spy(fg, conn8=True):
        calls.append(conn8)
        return LT.label_components_reference(fg, conn8)
    got = LT.compute_final_results_device(orig, _t(seg), marker, '40x',
                                          labeler=spy)
    want = LT.compute_final_results_device(orig, seg, marker, '40x',
                                           device='cpu')
    assert calls == [False, True]
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(TypeError):
        LT.compute_final_results_device(orig, seg, marker, mesh=None)


@pytest.mark.parametrize('h,w,ts,ov', [(130, 190, 64, 4), (64, 64, 64, 4),
                                       (100, 257, 64, 8)])
def test_ownership_maps_gather_matches_stitch_batch(h, w, ts, ov):
    img = np.random.default_rng(2).integers(0, 255, (h, w, 3), np.uint8)
    tiler = InferenceTiler(img, ts, ov)
    tiles = tiler.tiles()
    tiler.stitch_batch('k', tiles)
    tile_idx, ty, tx = (_t(a) for a in tiler.ownership_maps())
    dev = _t(tiles)[tile_idx, ty[:, None], tx[None, :]]
    np.testing.assert_array_equal(
        dev[:tiler.orig_height, :tiler.orig_width].numpy(),
        tiler.results()['k'])


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    """TINY_CFG's nets in the native npz layout, weights at the reference
    init (conv N(0, 0.02), norm scale N(1, 0.02), biases 0) from a numpy
    seed."""
    md = tmp_path_factory.mktemp('tiny_devquant_model')
    d = dl.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                       net_gs=('unet_32',) * 3, ngf=8,
                       seg_weights=(0.4, 0.3, 0.3))
    ens = dl.DeepLIIFNets(d)
    rng = np.random.default_rng(7)
    for group, nets_ in (('G', ens.G), ('GS', ens.GS)):
        out = {}
        for k, v in ck.flatten_tree(ck.params_to_jax(nets_[0])).items():
            shape = (len(nets_),) + v.shape
            out[k] = (rng.normal(0, 0.02, shape) if k.endswith('/w') else
                      1 + 0.02 * rng.normal(0, 1, shape) if
                      k.endswith('/scale') else np.zeros(shape)
                      ).astype(np.float32)
        np.savez(md / f'latest_net_{group}.npz', **out)
    with open(md / 'config.json', 'w') as f:
        json.dump(TINY_CFG, f)
    return str(md)


def test_infer_modalities_device_quant(model_dir, monkeypatch):
    """device_quant=True on a CPU session: the seg tiles are stitched on the
    session's device and quantified there; 'Seg' and every modality are
    byte-equal to the host-quantifier run, scoring equal, and 'Seg' and
    scoring equal to the JAX package's device_quant=True run."""
    img = Image.fromarray(np.random.default_rng(3).integers(
        0, 255, (100, 150, 3), np.uint8))
    stitched = []
    run_tiles = M.InferenceSession.run_tiles

    def spy(self, *a, **k):
        out = run_tiles(self, *a, **k)
        stitched.append(k.get('device_keys', ()))
        return out
    monkeypatch.setattr(M.InferenceSession, 'run_tiles', spy)
    dev_images, dev_scoring = M.infer_modalities(img, 64, model_dir,
                                                 device_quant=True,
                                                 device='cpu')
    host_images, host_scoring = M.infer_modalities(img, 64, model_dir,
                                                   device='cpu')
    assert stitched == [('GS',), ()]
    assert set(dev_images) == set(host_images)
    for k in host_images:
        if k not in ('SegOverlaid', 'SegRefined'):
            np.testing.assert_array_equal(np.asarray(dev_images[k]),
                                          np.asarray(host_images[k]))
    assert dev_scoring == host_scoring
    ref_images, ref_scoring = M_jax.infer_modalities(img, 64, model_dir,
                                                     device_quant=True)
    np.testing.assert_array_equal(np.asarray(dev_images['Seg']),
                                  np.asarray(ref_images['Seg']))
    assert dev_scoring == ref_scoring


def test_resolve_device_quant():
    """Explicit True/False win; 'auto' takes the host path on a CPU session
    or without a device canvas, and the device path on a CUDA canvas between
    the crossover and the cap."""
    for seg in (None, torch.zeros(4000, 4000, 3, dtype=torch.uint8)):
        assert M._resolve_device_quant(True, seg) is True
        assert M._resolve_device_quant(False, seg) is False
        assert M._resolve_device_quant('auto', seg) is False

    def cuda_canvas(h, w):
        return SimpleNamespace(device=torch.device('cuda'), shape=(h, w, 3))
    assert M._DEVICE_QUANT_MIN_PX == 256 * 256
    for side in (256, 512, 8192):
        assert M._resolve_device_quant('auto', cuda_canvas(side, side))
    assert not M._resolve_device_quant('auto', cuda_canvas(128, 256))
    assert M._resolve_device_quant(True, cuda_canvas(128, 128))
    big = int(M._DEVICE_QUANT_MAX_PX ** 0.5) + 1
    assert M._device_quant_fits(big - 1, big - 1)
    assert not M._device_quant_fits(big, big)
    assert not M._resolve_device_quant('auto', cuda_canvas(big, big))
    assert M._DEVICE_QUANT_MAX_PX < 2 ** 31


def test_cli_device_quant_on_cpu(model_dir, tmp_path):
    """``test --device-quant on`` on the CPU writes the files and scoring
    of ``--device-quant off``, with the same 'Seg' bytes."""
    from deepliif_tpu_torch import cli
    inp = tmp_path / 'in'
    inp.mkdir()
    Image.fromarray(np.random.default_rng(9).integers(
        0, 255, (96, 128, 3), np.uint8)).save(inp / 'sample.png')
    outs = {}
    for mode in ('on', 'off'):
        outs[mode] = tmp_path / mode
        cli.run_test(str(inp), str(outs[mode]), 64, model_dir,
                     device_quant=mode, device='cpu', echo=lambda *a: None)
    assert sorted(p.name for p in outs['on'].iterdir()) == \
        sorted(p.name for p in outs['off'].iterdir())
    for name in ('sample.json', 'sample_Seg.png'):
        assert (outs['on'] / name).read_bytes() == \
            (outs['off'] / name).read_bytes(), name
