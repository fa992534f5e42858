"""The port's whole-slide path (``utils.tiff``, ``utils.wsi``, the CLI's
``test-wsi`` and ``wsi-cells``) against the JAX package's (CPU).

- ``write_pyramid_tiff`` writes byte-equal files in both packages (deflate,
  uncompressed, JPEG, with a macro page and a description), and each
  package's reader reads the other's files;
- ``parse_magnification`` / ``get_wsi_resolution`` agree with JAX on the
  cases of tests/test_tiff_wsi.py;
- ``infer_results_for_wsi`` on a 200 x 260 slide (tile 64, region 128: four
  regions, three of them ragged) through the port's CLI (tile size from
  the slide's AppMag): the modalities and Seg within 1 LSB on fewer than
  0.1 % of pixels of JAX's; every level-0 canvas byte-equal to the stitch of
  ``infer_modalities`` on each region alone; the slide JSON equal to the sum
  of the JAX host quantifier's scoring of the port's own per-region Seg
  and marker, and the overlays equal to its overlays; a second run
  byte-equal;
- ``infer_cells_for_wsi``: the cells equal to the JAX cell quantifier run on
  the port's own per-region seg-only outputs, offset to slide coordinates;
- the salvage chain, ``_region_producer``'s error forwarding, and the
  formats the port does not read yet (NotImplementedError naming the
  "WSI" heading of ROADMAP.md).

Two tiny models: the reference init (conv weights N(0, 0.02), seeded) for
the comparison with the JAX session, the tolerance's setting
(tests/test_torch_port_inference.py); and conv weights N(0, 0.3) for the
checks against the JAX quantifier, wide enough that the random seg nets
draw cells on the IHC-like slide, so the scoring and the cell lists are not
empty (the port alone runs that model, so no float32 difference between
the frameworks enters them)."""

import json
import os
import queue

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import chip_smoke as smoke
from deepliif_tpu import postprocessing as pp_jax
from deepliif_tpu.utils import tiff as tiff_jax, wsi as wsi_jax
from deepliif_tpu_torch import cli, models as M
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.utils import checkpoints as ck
from deepliif_tpu_torch.utils import tiff, wsi
from test_tiff_wsi import BIF_XMP, SCN_XML, _svs_fixture
from test_wsi_salvage import _corrupt_first_tile

CFG = {'model': 'DeepLIIF', 'modalities_no': 2, 'seg_gen': True,
       'seg_no': 1, 'input_no': 1, 'netG': 'resnet_6blocks',
       'net_gs': 'unet_32', 'ngf': 8, 'ndf': 8, 'norm': 'batch',
       'no_dropout': False, 'padding': 'zero', 'upsample': 'convtranspose',
       'scale_size': 64, 'seg_weights': [0.4, 0.3, 0.3],
       'modalities_names': ['IHC', 'A', 'Marker'],
       'background_colors': [(201, 211, 208), (10, 10, 10)]}
# AppMag 5 -> tile round(5 / 40 * 512) = 64
DESC = 'Aperio Fake 260x200 |AppMag = 5|MPP = 2.0'
TILE, REGION = 64, 128


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers (torch's per-op
    pool oversubscribes the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_one_device():
    """The JAX sessions on one device (else this file's eight virtual CPU
    devices: a mesh and its compiles)."""
    mp = pytest.MonkeyPatch()
    mp.setenv('DEEPLIIF_INFER_DEVICES', '1')
    yield
    mp.undo()


def _write_model(md, std):
    """The tiny model with conv weights N(0, ``std``) from a numpy seed."""
    os.makedirs(md)
    d = dl.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                       net_gs=('unet_32',) * 3, ngf=8,
                       seg_weights=(0.4, 0.3, 0.3))
    rng = np.random.default_rng(7)
    for group, mods in dl.DeepLIIFNets(d).named_groups():
        flat = ck.flatten_tree(ck.params_to_jax(mods[0]))
        out = {}
        for k, v in flat.items():
            shape = (len(mods),) + v.shape
            if k.endswith('/w'):
                out[k] = rng.normal(0, std, shape).astype(np.float32)
            elif k.endswith('/scale'):
                out[k] = (1 + 0.02 * rng.normal(0, 1, shape)).astype(
                    np.float32)
            else:
                out[k] = np.zeros(shape, np.float32)
        np.savez(os.path.join(md, f'latest_net_{group}.npz'), **out)
    with open(os.path.join(md, 'config.json'), 'w') as f:
        json.dump(CFG, f)
    return md


@pytest.fixture(scope='module')
def slide(tmp_path_factory):
    """(the model that draws cells, slide dir, slide pixels, the
    reference-init model)."""
    root = tmp_path_factory.mktemp('wsi_port')
    md = _write_model(str(root / 'model'), 0.3)
    md_ref = _write_model(str(root / 'model_ref'), 0.02)
    wsi_dir = str(root / 'wsi')
    os.makedirs(wsi_dir)
    pixels = smoke.ihc_like_image(260, 2)[:200]
    tiff.write_pyramid_tiff(os.path.join(wsi_dir, 'slide.tiff'), pixels,
                            description=DESC)
    return md, wsi_dir, pixels, md_ref


def _regions(h, w):
    return [(x, y, min(REGION, w - x), min(REGION, h - y))
            for y in range(0, h, REGION) for x in range(0, w, REGION)]


def _test_wsi(md, wsi_dir, out):
    """The port's test-wsi through its CLI (tile size from the slide's
    AppMag); returns the CLI output."""
    res = CliRunner().invoke(cli.make_cli(), [
        'test-wsi', '--input-dir', wsi_dir, '--filename', 'slide.tiff',
        '--output-dir', out, '--model-dir', md, '--region-size', str(REGION),
        '--device', 'cpu'])
    assert res.exit_code == 0, res.output
    return res.output


def _levels0(out_dir):
    """{output name: level-0 pixels} of the .ome.tiff files in out_dir, read
    by the port's reader."""
    got = {}
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith('.ome.tiff'):
            r = tiff.TiledTiffReader(os.path.join(out_dir, fn))
            w, h = r.size
            got[fn[len('slide_'):-len('.ome.tiff')]] = r.read_region(0, 0, w,
                                                                     h)
            r.close()
    return got


@pytest.fixture(scope='module')
def port_run(slide, tmp_path_factory):
    """The port's test-wsi through its CLI, twice: per run (level-0
    outputs, slide JSON, CLI output, files written)."""
    md, wsi_dir = slide[:2]
    runs = []
    for i in range(2):
        out = str(tmp_path_factory.mktemp(f'port_out{i}'))
        output = _test_wsi(md, wsi_dir, out)
        with open(os.path.join(out, 'slide.json')) as f:
            runs.append((_levels0(out), json.load(f), output,
                         sorted(os.listdir(out))))
    return runs


def test_test_wsi_matches_jax(slide, jax_one_device, tmp_path):
    _, wsi_dir, _, md = slide
    port_out, jax_out = str(tmp_path / 'port'), str(tmp_path / 'jax')
    output = _test_wsi(md, wsi_dir, port_out)
    assert 'tile size 64 from slide magnification metadata' in output
    wsi_jax.infer_results_for_wsi(wsi_dir, 'slide.tiff', jax_out, md,
                                  tile_size=TILE, region_size=REGION)
    got, ref = _levels0(port_out), _levels0(jax_out)
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    assert set(got) == set(ref) == {'mod1-A', 'mod2-Marker', 'Seg',
                                    'SegOverlaid', 'SegRefined'}
    for k in ('mod1-A', 'mod2-Marker', 'Seg'):
        assert got[k].shape == (200, 260, 3)
        d = np.abs(got[k].astype(np.int16) - ref[k].astype(np.int16))
        assert d.max() <= 1
        assert (d > 0).mean() < 1e-3


def test_test_wsi_is_the_per_region_stitch(slide, port_run):
    """Each level-0 canvas equals the stitch of infer_modalities on each
    region alone; the slide JSON the sum of the JAX host quantifier's
    scoring of the port's per-region Seg and marker; a second run gives the
    same bytes."""
    md, _, pixels, _ = slide
    (got, scoring, _, _), (again, scoring2, _, _) = port_run
    stitch = {k: np.zeros_like(v) for k, v in got.items()}
    total = {'num_total': 0, 'num_pos': 0, 'num_neg': 0}
    for x, y, w, h in _regions(*pixels.shape[:2]):
        region = Image.fromarray(pixels[y:y + h, x:x + w])
        images, _ = M.infer_modalities(region, TILE, md, device='cpu')
        for k, im in images.items():
            stitch[k][y:y + h, x:x + w] = np.asarray(im)
        overlay, refined, score = pp_jax.compute_final_results(
            region, images['Seg'],
            pp_jax.to_array(images['mod2-Marker'], True), '10x')
        np.testing.assert_array_equal(np.asarray(images['SegOverlaid']),
                                      overlay)
        np.testing.assert_array_equal(np.asarray(images['SegRefined']),
                                      refined)
        for k in total:
            total[k] += score[k]
    for k in got:
        np.testing.assert_array_equal(got[k], stitch[k], err_msg=k)
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)
    assert total['num_total'] > 0
    total['percent_pos'] = round(total['num_pos'] / total['num_total'] * 100,
                                 1)
    assert scoring == scoring2 == total


def test_wsi_cells_match_jax_quantifier(slide, tmp_path):
    md, wsi_dir, pixels, _ = slide
    res = CliRunner().invoke(cli.make_cli(), [
        'wsi-cells', '--input-dir', wsi_dir, '--filename', 'slide.tiff',
        '--output-dir', str(tmp_path), '--model-dir', md, '--region-size',
        str(REGION), '--device', 'cpu'])
    assert res.exit_code == 0, res.output
    with open(tmp_path / 'slide_cells.json') as f:
        got = json.load(f)
    session = M.init_nets(md, device='cpu')
    cells, size_t, marker_t = [], [], []
    for x, y, w, h in _regions(*pixels.shape[:2]):
        images = M.inference(Image.fromarray(pixels[y:y + h, x:x + w]), TILE,
                             TILE // 16, md, opt=session.opt, seg_only=True,
                             session=session)
        data = pp_jax.compute_cell_results(images['Seg'],
                                           images['mod2-Marker'], '10x',
                                           version=3)
        size_t.append(data['settings']['default_size_thresh'])
        if data['settings'].get('default_marker_thresh') is not None:
            marker_t.append(data['settings']['default_marker_thresh'])
        for c in data['cells']:
            c['bbox'] = [(c['bbox'][0][0] + x, c['bbox'][0][1] + y),
                         (c['bbox'][1][0] + x, c['bbox'][1][1] + y)]
            c['centroid'] = (c['centroid'][0] + x, c['centroid'][1] + y)
            c['boundary'] = [(bx + x, by + y) for bx, by in c['boundary']]
            cells.append(pp_jax.encode_cell_data_v4(c))
    assert len(cells) > 0
    assert f'{len(cells)} cells' in res.output
    assert got['cells'] == json.loads(json.dumps(cells))
    assert got['settings']['default_size_thresh'] == int(round(np.mean(
        size_t)))
    assert got['settings']['default_marker_thresh'] == (
        int(round(np.mean(marker_t))) if marker_t else None)
    assert got['dataVersion'] == 4


# ---------------------------------------------------------------------------
# TIFF I/O and slide metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kw', [
    {}, {'compression': False, 'levels': (1, 2)},
    {'compression': 'jpeg', 'description': DESC},
    {'compression': False, 'levels': (1, 2), 'description': SCN_XML,
     'macro': 'macro'},
    {'levels': (1,), 'tile': 64, 'software': 'MedScan 1.0',
     'description': 'OverlapsXY=16 16'}])
def test_pyramid_tiff_byte_equal_to_jax(tmp_path, kw):
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 255, (300, 410, 3), np.uint8)
    if kw.get('macro') == 'macro':
        kw = dict(kw, macro=rng.integers(0, 255, (60, 80, 3), np.uint8))
    port, ref = str(tmp_path / 'port.tiff'), str(tmp_path / 'jax.tiff')
    tiff.write_pyramid_tiff(port, canvas, **kw)
    tiff_jax.write_pyramid_tiff(ref, canvas, **kw)
    with open(port, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()


@pytest.mark.parametrize('compression', [True, 'jpeg'])
def test_readers_read_each_others_files(tmp_path, compression):
    canvas = smoke.ihc_like_image(300, 3)[:260]
    for writer, reader in ((tiff.write_pyramid_tiff, tiff_jax.TiledTiffReader),
                           (tiff_jax.write_pyramid_tiff, tiff.TiledTiffReader)):
        path = str(tmp_path / f'{writer.__module__}.svs')
        writer(path, canvas, levels=(1, 2), compression=compression,
               description=DESC)
        r = reader(path)
        own = (tiff.TiledTiffReader if reader is tiff_jax.TiledTiffReader
               else tiff_jax.TiledTiffReader)(path)
        assert r.size == own.size == (300, 260)
        for args in ((0, 0, 300, 260), (37, 51, 200, 150),
                     (0, 0, 150, 130, 1)):
            np.testing.assert_array_equal(r.read_region(*args),
                                          own.read_region(*args))
        if compression is True:
            np.testing.assert_array_equal(r.read_region(0, 0, 300, 260),
                                          canvas)
        assert r.get_magnification() == own.get_magnification() == 5.0
        r.close()
        own.close()


@pytest.mark.parametrize('desc', [
    '<OME><Instrument><Objective ID="Objective:0" '
    'NominalMagnification="40.0"/></Instrument></OME>',
    'Magnification: 10', 'no info here', None, DESC, SCN_XML, BIF_XMP,
    '<scn><collection><image name="macro"><scanSettings><objectiveSettings>'
    '<objective>0.8</objective></objectiveSettings></scanSettings></image>'
    '<image name="main"><scanSettings><objectiveSettings><objective>40'
    '</objective></objectiveSettings></scanSettings></image></collection>'
    '</scn>'])
def test_parse_magnification_matches_jax(desc):
    assert tiff.parse_magnification(desc) == tiff_jax.parse_magnification(
        desc)


def test_wsi_resolution_matches_jax(tmp_path):
    svs = str(tmp_path / 'slide.svs')
    _svs_fixture(svs, mag=20)
    png = str(tmp_path / 'plain.png')
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(png)
    cases = [svs, '40', 20, '10.0', str(tmp_path / 'nope.svs'), png, None]
    got = [wsi.get_wsi_resolution(c) for c in cases]
    assert got == [wsi_jax.get_wsi_resolution(c) for c in cases]
    assert got[:4] == [256, 512, 256, 128]
    assert cli._resolve_wsi_tile_size(None, str(tmp_path), 'slide.svs',
                                      echo=lambda *_: None) == 256
    assert cli._resolve_wsi_tile_size(None, str(tmp_path), 'plain.png',
                                      echo=lambda *_: None) == 512
    assert cli._resolve_wsi_tile_size(96, str(tmp_path), 'plain.png') == 96


# ---------------------------------------------------------------------------
# readers: salvage, fallbacks, unported formats
# ---------------------------------------------------------------------------

def test_salvage_chain_matches_jax(tmp_path):
    canvas = np.random.default_rng(0).integers(0, 255, (1200, 1400, 3),
                                               np.uint8)
    path = str(tmp_path / 'slide.tiff')
    tiff.write_pyramid_tiff(path, canvas, levels=(1,))
    _corrupt_first_tile(path)
    r = tiff.TiledTiffReader(path)
    with pytest.raises(Exception):
        r.read_region(0, 0, 1400, 1200)
    r.close()
    got, ref = wsi.WSIReader(path), wsi_jax.WSIReader(path)
    out = got.read_region(0, 0, 1400, 1200)
    np.testing.assert_array_equal(out, ref.read_region(0, 0, 1400, 1200))
    assert (out[:1024, :1024] == 0).all()
    np.testing.assert_array_equal(out[1024:], canvas[1024:])
    got.close()
    ref.close()


def test_truncated_and_bogus_slides_fail_fast(tmp_path):
    canvas = np.zeros((300, 300, 3), np.uint8)
    path = str(tmp_path / 'trunc.tiff')
    tiff.write_pyramid_tiff(path, canvas, levels=(1,))
    with open(path, 'rb') as f:
        data = f.read()
    with open(path, 'wb') as f:
        f.write(data[:len(data) // 2])
    junk = str(tmp_path / 'junk.svs')
    with open(junk, 'wb') as f:
        f.write(b'this is not a slide' * 100)
    for p in (path, junk):
        with pytest.raises(Exception):
            wsi.WSIReader(p)


def test_pil_fallback_matches_jax(tmp_path):
    """A non-TIFF slide takes PIL in both packages: same size, magnification
    and pixels."""
    canvas = smoke.ihc_like_image(90, 4)[:70]
    path = str(tmp_path / 'slide.png')
    Image.fromarray(canvas).save(path)
    got, ref = wsi.WSIReader(path), wsi_jax.WSIReader(path)
    assert got._tiled is None and got.size == ref.size == (90, 70)
    assert got.get_information() == ref.get_information()
    np.testing.assert_array_equal(got.read_region(5, 7, 40, 30),
                                  ref.read_region(5, 7, 40, 30))
    got.close()
    ref.close()


def test_region_producer_forwards_errors():
    class Bad:
        def read_region(self, *a):
            raise MemoryError('region allocation failed')

    class Good:
        def read_region(self, x, y, w, h):
            return np.zeros((h, w, 3), np.uint8)

    q = queue.Queue()
    wsi._region_producer(Bad(), [(0, 0, 4, 4)], q)
    item = q.get_nowait()
    assert item[0] == 'error' and isinstance(item[1], MemoryError)
    q2 = queue.Queue()
    wsi._region_producer(Good(), [(0, 0, 4, 4), (4, 0, 4, 4)], q2)
    assert q2.get_nowait()[0] == (0, 0, 4, 4)
    assert q2.get_nowait()[0] == (4, 0, 4, 4)
    assert q2.get_nowait() is None


@pytest.mark.parametrize('name', ['s.mrxs', 's.czi', 's.dcm', 's.vms',
                                  's.vmu', 's.vsi', 's.ets', 's.svslide',
                                  's.zarr', 'ngff_dir'])
def test_unported_formats_name_the_wsi_heading(tmp_path, name):
    path = tmp_path / name
    if name.endswith('.zarr'):
        path.mkdir()
    elif name == 'ngff_dir':
        path.mkdir()
        (path / '.zattrs').write_text('{}')
    else:
        path.write_bytes(b'\0' * 64)
    with pytest.raises(NotImplementedError, match='ROADMAP.md, "WSI"'):
        wsi.WSIReader(str(path))
    res = CliRunner().invoke(cli.make_cli(), [
        'test-wsi', '--input-dir', str(tmp_path), '--filename', name,
        '--output-dir', str(tmp_path / 'out'), '--model-dir', str(tmp_path),
        '--tile-size', '64', '--device', 'cpu'])
    assert isinstance(res.exception, NotImplementedError), res.output
