"""The port's own copies of the JAX package's host modules (``config``,
``utils.luma_u8``, ``utils.tiler``, ``postprocessing`` with its C++ helper)
against the originals, the lazy builds from many threads at once (the C++
helper and, with a stand-in nvcc, ``ops.cuda_build``), and the errors for
what is not ported yet.

Tolerance: none. The copies run the same numpy/scipy code, so results are
equal: the scoring dict equal and the overlays byte-equal, on a synthetic
seg canvas with cells (the count comparison is not vacuous), tiles and
stitched canvases byte-equal, options equal."""

import json
import os
import re
import stat
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from deepliif_tpu import config as config_jax, models as M_jax
from deepliif_tpu import native as native_jax, postprocessing as pp_jax
from deepliif_tpu import utils as utils_jax
from deepliif_tpu.utils import tiler as tiler_jax
from deepliif_tpu_torch import cli, config, models as M, native
from deepliif_tpu_torch import nets, postprocessing as pp, roadmap, utils
from deepliif_tpu_torch.utils import tiler, wsi
from test_inference import TINY_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seg_canvas(size=512, seed=0):
    """Seg output with red (positive) and blue (negative) disks, some
    touching, a few noise specks, on black; a marker image that is bright
    in some cells; an IHC-like original."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((size, size, 3), np.uint8)
    marker = rng.integers(0, 40, (size, size), np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for _ in range(60):
        cy, cx = rng.integers(12, size - 12, 2)
        r = rng.uniform(4, 11)
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        positive = rng.random() < 0.4
        seg[disk] = (230, 25, 30) if positive else (25, 30, 230)
        if positive or rng.random() < 0.2:
            marker[disk] = rng.integers(120, 255)
    for _ in range(15):
        y, x = rng.integers(0, size - 2, 2)
        seg[y:y + 2, x:x + 2] = (200, 10, 10)
    orig = np.clip(rng.normal(215, 8, (size, size, 3)), 0, 255).astype(np.uint8)
    return orig, seg, marker


@pytest.mark.parametrize('resolution,size_thresh,marker_thresh', [
    ('40x', 'default', None), ('20x', None, 'default'), ('10x', 30, 100)])
def test_compute_final_results_matches_jax(resolution, size_thresh,
                                           marker_thresh):
    orig, seg, marker = _seg_canvas()
    kw = dict(size_thresh=size_thresh, marker_thresh=marker_thresh)
    ref = pp_jax.compute_final_results(orig, seg, marker, resolution, **kw)
    got = pp.compute_final_results(orig, seg, marker, resolution, **kw)
    assert got[2] == ref[2]
    assert ref[2]['num_total'] > 10 and 0 < ref[2]['num_pos'] < ref[2]['num_total']
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_engine_postprocess_matches_jax():
    """models.postprocess of both packages on the same images (the port's
    host quantifier end to end, the marker read as the per-pixel RGB max)."""
    orig, seg, marker = _seg_canvas(seed=1)
    images = {'Seg': Image.fromarray(seg),
              'mod4-Marker': Image.fromarray(np.stack([marker] * 3, -1))}
    ref_img, ref_scoring = M_jax.postprocess(Image.fromarray(orig), images,
                                             512, 'DeepLIIF',
                                             device_quant=False)
    got_img, scoring = M.postprocess(Image.fromarray(orig), images, 512,
                                     'DeepLIIF')
    assert scoring == ref_scoring and scoring['num_total'] > 0
    assert set(got_img) == set(ref_img)
    for k in ref_img:
        np.testing.assert_array_equal(np.asarray(got_img[k]),
                                      np.asarray(ref_img[k]))


def test_native_helpers_match_jax_and_build_outside_the_sources():
    rng = np.random.default_rng(2)
    mask = (rng.random((96, 80)) < 0.45).astype(np.uint8)
    assert native.available()
    lab, n = native.label8(mask)
    ref_lab, ref_n = native_jax.label8(mask)
    assert n == ref_n
    np.testing.assert_array_equal(lab, ref_lab)
    ys, xs = np.nonzero(mask)
    for y, x in list(zip(ys, xs))[:25]:
        assert native.moore_trace(mask, int(x), int(y)) == \
            native_jax.moore_trace(mask, int(x), int(y))
    csrc = os.path.join(REPO, 'deepliif_tpu_torch', 'csrc')
    assert not [f for f in os.listdir(csrc) if f.endswith('.so')]
    build = os.path.join(REPO, 'deepliif_tpu_torch', '_build')
    assert any(f.startswith('libpostproc-') for f in os.listdir(build))


def _race(fn, n=8):
    """``fn()`` from ``n`` threads released together, with a short switch
    interval; returns the results."""
    barrier = threading.Barrier(n)
    out = [None] * n

    def run(i):
        barrier.wait()
        out[i] = fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    return out


def test_native_load_from_many_threads_builds_once(tmp_path, monkeypatch):
    """Eight threads on a cold ``native._load`` all get the library: none
    finds it 'tried' while the first one builds, and it is built once."""
    monkeypatch.setattr(native, '_BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_tried', False)
    builds = []
    build = native._build
    monkeypatch.setattr(native, '_build',
                        lambda path: builds.append(path) or build(path))
    libs = _race(native._load)
    assert all(lib is not None for lib in libs)
    assert len({id(lib) for lib in libs}) == 1
    assert len(builds) == 1
    assert [f for f in os.listdir(tmp_path) if f.endswith('.so')] == \
        [os.path.basename(builds[0])]


def test_cuda_build_from_many_threads_builds_once(tmp_path, monkeypatch):
    """Eight threads asking ``cuda_build.load`` for one library at once get
    one handle, and the compiler runs once (a stand-in for nvcc that builds
    an empty shared library with the system C compiler and logs each
    run)."""
    from deepliif_tpu_torch.ops import cuda_build
    csrc, log = tmp_path / 'csrc', tmp_path / 'nvcc.log'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('// a kernel\n')
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'echo "$2" >> {log}\nsleep 0.2\n'
                    'exec cc -shared -fPIC -o "$2" -x c /dev/null\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, 'CSRC', str(csrc))
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(cuda_build, '_nvcc', lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, '_loaded', {})
    handles = _race(lambda: cuda_build.load('k', ['k.cu']))
    assert len({id(h) for h in handles}) == 1
    runs = log.read_text().split()
    # one run, into a temporary file named by the pid and the thread id
    assert len(runs) == 1
    assert re.search(rf'\.tmp-{os.getpid()}-\d+$', runs[0]), runs
    assert os.listdir(tmp_path / 'build') == [
        os.path.basename(cuda_build._lib_path('k', ['k.cu']))]


def test_luma_and_tiler_match_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (217, 300, 3), np.uint8)
    np.testing.assert_array_equal(utils.luma_u8(img), utils_jax.luma_u8(img))
    for tile, overlap in ((128, 8), (96, 0)):
        t, r = tiler.InferenceTiler(img, tile, overlap), \
            tiler_jax.InferenceTiler(img, tile, overlap)
        tiles = t.tiles()
        np.testing.assert_array_equal(tiles, r.tiles())
        for key, batch in (('a', tiles), ('b', 255 - tiles)):
            t.stitch_batch(key, batch)
            r.stitch_batch(key, batch)
        got, ref = t.results(), r.results()
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_get_opt_and_print_options_match_jax(tmp_path, capsys):
    js = tmp_path / 'js'
    js.mkdir()
    with open(js / 'config.json', 'w') as f:
        json.dump(dict(TINY_CFG, precision='bfloat16'), f)
    ref = config_jax.get_opt(str(js), mode='test')
    assert vars(config.get_opt(str(js), mode='test')) == vars(ref)
    txt = tmp_path / 'txt'
    txt.mkdir()
    with open(txt / 'train_opt.txt', 'w') as f:
        f.write(config_jax.format_options(ref) + '\n')
    assert vars(config.get_opt(str(txt))) == vars(config_jax.get_opt(str(txt)))
    config_jax.print_options(ref)
    want = capsys.readouterr().out
    config.print_options(ref)
    assert capsys.readouterr().out == want


def _roadmap_headings():
    with open(os.path.join(REPO, 'ROADMAP.md')) as f:
        return {m.group(1).strip() for m in
                re.finditer(r'^#{2,6} (.+)$', f.read(), re.M)}


def test_roadmap_items_follow_queue_order():
    """roadmap.ITEMS lists the Queue 1 headings of ROADMAP.md in their
    order there."""
    with open(os.path.join(REPO, 'ROADMAP.md')) as f:
        order = [m.group(1).strip() for m in
                 re.finditer(r'^#### (.+)$', f.read(), re.M)]
    assert [h for h in order if h in roadmap.ITEMS] == list(roadmap.ITEMS)


def test_not_ported_messages_name_roadmap_headings(tmp_path, monkeypatch):
    """Every item a "not ported" error can name is a heading of ROADMAP.md,
    the errors raised name one, and no message of the port cites an item
    by number."""
    headings = _roadmap_headings()
    assert set(roadmap.ITEMS) <= headings, set(roadmap.ITEMS) - headings
    with pytest.raises(ValueError):
        roadmap.not_ported('x', 'Queue 1 item 7')

    errors = []
    for call in (
            lambda: cli.int8_options({'DEEPLIIF_INT8_DYN': '0'}, 'int8'),
            lambda: nets.ResnetGenerator(3, 3, 8, n_blocks=2)(
                torch.zeros(1, 3, 16, 16)),
            lambda: nets.define_g(3, 3, 8, 'unet_32')(
                torch.zeros(1, 3, 32, 32)),
            lambda: nets.define_g(3, 3, 8, 'unet_512_attention')(
                torch.zeros(1, 3, 256, 256)),
            lambda: wsi.WSIReader(str(tmp_path / 'slide.czi')),
            lambda: M.InferenceSession(str(tmp_path), device='cpu')):
        with monkeypatch.context() as mp:
            mp.setenv('DEEPLIIF_INFER_DEVICES', '2')
            with pytest.raises(NotImplementedError) as e:
                call()
        errors.append(str(e.value))
    assert '"WSI"' in errors[-2] and '"Serving"' in errors[-1]
    for msg in errors:
        item = re.search(r'ROADMAP\.md, "([^"]+)"', msg)
        assert item and item.group(1) in headings, msg

    stale = []
    for root, _, files in os.walk(os.path.join(REPO, 'deepliif_tpu_torch')):
        for fn in files:
            if fn.endswith(('.py', '.cu', '.cuh', '.cc')):
                with open(os.path.join(root, fn)) as f:
                    text = f.read()
                if re.search(r'ROADMAP[^\n]{0,40}item \d', text):
                    stale.append(fn)
    assert not stale, stale
