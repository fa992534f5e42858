"""The port's connected-components labeling (``ops.labeling``) on masks made
to stress a tiled labeling at its tile borders (``chip_smoke.
adversarial_masks``: serpentine, comb, checkerboard, diagonals, percolation),
at conn 4 and 8, and on 1-pixel-tall, 1-pixel-wide and ragged canvases.

On the CPU:
- the plain labeling (``label_components_reference``, what a CPU tensor
  runs) against JAX's XLA ``label_components`` and its Pallas kernel
  ``label_components_pallas`` in interpret mode;
- an emulation of the tiled algorithm of ``csrc/label_cc.cu`` (a
  union-find per tile over the runs of its rows, rows and tile borders united
  only where runs first touch, then every label resolved to its root) at
  small tile shapes and the kernel's own (16 x 256), against the plain
  labeling: the union rules that the kernel skips must be implied by those
  it makes.

On the card (``cuda`` marker; skipped without one): the kernel bit-equal to
the plain labeling on the same masks at sizes of many tiles and at ragged
ones, on the two masks of the synthetic seg canvas, with one launch counted
per call and a second launch byte-equal.

Tolerance: none. Labels are integers and equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as smoke
from deepliif_tpu.ops import labeling as LJ
from deepliif_tpu_torch.ops import labeling as LT


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Torch on one thread in this module: the plain labeling is many small
    whole-canvas ops, and beside the suite's other workers a thread pool per
    op is oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# jitted once per shape and static argument (eagerly, each call compiles the
# while loops anew)
_LABEL_XLA = jax.jit(LJ.label_components, static_argnames='conn8')
_LABEL_PALLAS = jax.jit(LJ.label_components_pallas,
                        static_argnames=('conn8', 'interpret'))

MASKS = ('serpentine', 'comb', 'checkerboard', 'diagonals', 'percolation')
CONNS = [pytest.param(False, id='conn4'), pytest.param(True, id='conn8')]
# ragged, 1 pixel tall, 1 pixel wide
SHAPES = [(67, 131), (1, 131), (67, 1)]


def _mask(name, shape, seed=3):
    return smoke.adversarial_masks(*shape, seed)[name]


@pytest.mark.parametrize('conn8', CONNS)
@pytest.mark.parametrize('name', MASKS)
def test_plain_labeling_matches_jax(name, conn8):
    """The plain labeling bit-equal to JAX's XLA labeling and to its Pallas
    kernel (interpret mode) on a ragged canvas; the serpentine and the comb
    are one component each."""
    fg = _mask(name, SHAPES[0])
    got = LT.label_components(torch.from_numpy(fg), conn8=conn8).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(_LABEL_XLA(jnp.asarray(fg), conn8=conn8)))
    np.testing.assert_array_equal(
        got, np.asarray(_LABEL_PALLAS(jnp.asarray(fg), conn8=conn8,
                                      interpret=True)))
    if name in ('serpentine', 'comb'):
        assert set(np.unique(got)) == {0, 1}
    if name == 'checkerboard':
        n_comp = len(np.unique(got)) - 1
        assert n_comp == (fg.sum() if not conn8 else 1)


@pytest.mark.parametrize('conn8', CONNS)
@pytest.mark.parametrize('shape', SHAPES[1:], ids=['1xW', 'Hx1'])
def test_plain_labeling_thin_canvases_match_jax(shape, conn8):
    """One-pixel-tall and one-pixel-wide canvases: every mask against the
    XLA labeling."""
    for name in MASKS:
        fg = _mask(name, shape)
        got = LT.label_components(torch.from_numpy(fg), conn8=conn8).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(_LABEL_XLA(jnp.asarray(fg), conn8=conn8)),
            err_msg=name)


# ---- the tiled algorithm of csrc/label_cc.cu, emulated pixel by pixel

class _UnionFind:
    """Links toward the smaller index, as the kernel's atomicMin does."""

    def __init__(self, parent):
        self.parent = parent

    def find(self, a):
        while self.parent[a] != a:
            a = self.parent[a]
        return a

    def unite(self, a, b):
        a, b = self.find(a), self.find(b)
        if a != b:
            self.parent[max(a, b)] = min(a, b)


def _tiled_labels(fg, conn8, th, tw):
    """label_cc.cu's three passes on a numpy mask, tile (th, tw): local
    union-find per tile (a run's pixels joined to its first pixel; rows
    united where runs first touch), border unions on the labels (parent + 1)
    by the first-row and first-column rules, and the resolve pass."""
    h, w = fg.shape

    def on(y, x):
        return 0 <= y < h and 0 <= x < w and bool(fg[y, x])

    def row_rules(f, y, x):
        """Neighbours in the row above that pixel (y, x) unites with."""
        up, left, up_left = f(y - 1, x), f(y, x - 1), f(y - 1, x - 1)
        if not conn8:
            return [(y - 1, x)] if up and not (left and up_left) else []
        out = [(y - 1, x + 1)] if f(y - 1, x + 1) and not up else []
        if not left:
            if up:
                out.append((y - 1, x))
            elif up_left:
                out.append((y - 1, x - 1))
        return out

    labels = np.zeros(h * w, np.int64)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            def local(ly, lx):
                return 0 <= ly < th and 0 <= lx < tw and on(y0 + ly, x0 + lx)
            uf = _UnionFind(np.arange(th * tw))
            for ly in range(th):
                for lx in range(tw):
                    if not local(ly, lx):
                        continue
                    if local(ly, lx - 1):
                        uf.unite(ly * tw + lx, ly * tw + lx - 1)
                    if ly > 0:
                        for qy, qx in row_rules(local, ly, lx):
                            uf.unite(ly * tw + lx, qy * tw + qx)
            for ly in range(th):
                for lx in range(tw):
                    if local(ly, lx):
                        r = uf.find(ly * tw + lx)
                        labels[(y0 + ly) * w + x0 + lx] = \
                            (y0 + r // tw) * w + x0 + r % tw + 1
    uf = _UnionFind(labels - 1)
    for y in range(h):
        for x in range(w):
            if not on(y, x):
                continue
            pairs = []
            if y % th == 0 and y > 0:
                pairs += row_rules(on, y, x)
            if x % tw == 0 and x > 0:
                inner = y % th != 0          # up is in p's tile
                if not conn8:
                    if on(y, x - 1) and not (inner and on(y - 1, x)
                                             and on(y - 1, x - 1)):
                        pairs.append((y, x - 1))
                elif on(y, x - 1):
                    pairs.append((y, x - 1))
                else:
                    if inner and on(y - 1, x - 1) and not on(y - 1, x):
                        pairs.append((y - 1, x - 1))
                    if on(y + 1, x - 1) and not on(y + 1, x):
                        pairs.append((y + 1, x - 1))
            for qy, qx in pairs:
                uf.unite(y * w + x, qy * w + qx)
    out = np.array([uf.find(v - 1) + 1 if v else 0 for v in labels])
    return out.reshape(h, w)


KERNEL_TILE = (16, 256)      # label_cc.cu's TH x 32 * WPR
TILES = [(2, 3), (3, 1), (1, 4), (4, 8), (5, 32), KERNEL_TILE]


@pytest.mark.parametrize('conn8', CONNS)
@pytest.mark.parametrize('name', MASKS)
def test_tiled_algorithm_matches_plain_labeling(name, conn8):
    """The kernel's union rules, emulated at small tiles (many tile borders
    and corners on a 67 x 131 canvas, 1-pixel tiles on an axis included)
    and at the kernel's own tile shape, give the plain labeling's labels."""
    for shape in ((67, 131), (40, 600)):
        fg = _mask(name, shape)
        want = LT.label_components_reference(torch.from_numpy(fg),
                                             conn8=conn8).numpy()
        for th, tw in TILES:
            if shape == (40, 600) and (th, tw) != KERNEL_TILE:
                continue
            np.testing.assert_array_equal(
                _tiled_labels(fg, conn8, th, tw), want,
                err_msg=f'{shape} tile {th}x{tw}')


def test_wrapper_contract_on_cpu():
    """A CPU tensor runs the plain version and launches nothing; another
    device raises."""
    fg = torch.from_numpy(_mask('comb', (20, 30)))
    n0 = LT.label_components.launches
    got = LT.label_components(fg.to(torch.uint8) * 7, conn8=False)
    assert got.dtype == torch.int32 and got.shape == fg.shape
    assert torch.equal(got, LT.label_components_reference(fg, conn8=False))
    assert LT.label_components.launches == n0
    with pytest.raises(ValueError):
        LT.label_components(fg.to('meta'))


# ---- the kernel on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _kernel_vs_plain(fg, conn8):
    n0 = LT.label_components.launches
    got = LT.label_components(fg, conn8=conn8)
    assert LT.label_components.launches == n0 + 1
    assert got.dtype == torch.int32 and got.shape == fg.shape
    want = LT.label_components_reference(fg, conn8=conn8)
    assert torch.equal(got, want)
    assert torch.equal(LT.label_components(fg, conn8=conn8), got)


CARD_SHAPES = [(1000, 1030), (2047, 3001), (1024, 2048), (777, 1201),
               (1, 5000), (5000, 1), (67, 131)]


@pytest.mark.cuda
@pytest.mark.parametrize('conn8', CONNS)
@pytest.mark.parametrize('name', MASKS)
@pytest.mark.parametrize('shape', CARD_SHAPES,
                         ids=['x'.join(map(str, s)) for s in CARD_SHAPES])
def test_cuda_label_kernel_matches_plain(cuda, shape, name, conn8):
    """Bit-equal to the plain labeling at sizes of many tiles, at ragged
    ones (widths not a multiple of 16 take the kernel's byte loads) and on
    1-pixel canvases; one launch per call; a second launch byte-equal."""
    _kernel_vs_plain(torch.from_numpy(_mask(name, shape)).cuda(), conn8)


@pytest.mark.cuda
@pytest.mark.parametrize('conn8', CONNS)
def test_cuda_label_kernel_synthetic_canvas(cuda, conn8):
    """The two masks the quantifier labels on the synthetic seg canvas
    (1536 x 1280): conn 4 on the unknown mask, conn 8 on the cell mask; as
    uint8 0/255 too."""
    _, seg, _ = smoke.synthetic_seg_canvas(1536, 1280, smoke.SEED)
    fg = smoke.label_masks(LT, seg)[8 if conn8 else 4]
    _kernel_vs_plain(fg, conn8)
    assert torch.equal(LT.label_components(fg.to(torch.uint8) * 255, conn8),
                       LT.label_components(fg, conn8))


@pytest.mark.cuda
def test_cuda_label_kernel_rejects(cuda):
    """A float or 3-D mask raises; nothing is launched."""
    n0 = LT.label_components.launches
    with pytest.raises(TypeError):
        LT.label_components(torch.zeros(8, 8, device='cuda'))
    with pytest.raises(TypeError):
        LT.label_components(torch.zeros(2, 8, 8, dtype=torch.bool,
                                        device='cuda'))
    assert LT.label_components.launches == n0
