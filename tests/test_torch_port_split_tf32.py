"""The float32 trunk conv's split-TF32 arithmetic, on the CPU: the plain
split-TF32 version (``conv3x3_stats_split_tf32_reference``, what the card's
kernel computes, up to the order of its float32 sums) against the JAX
Pallas kernel in interpret mode and against the plain float32 version,
with 1x TF32 as the control that must miss; ``tf32_round`` against a
rounding written out in exact rational arithmetic; a 9-block chain. The
``cuda`` cases hold the kernel to its plain version on the card.

Tolerances: y within 1e-4 absolute (the repo's float32 layer tolerance,
tests/test_fused_resblock.py and chip_smoke.Y_TOL); stats within 1e-5 of
the largest stat of their kind on the CPU (float32 sums in another order)
and 1e-4 on the card (chip_smoke.STATS_TOL). 1x TF32 (hi * hi alone) keeps
about 3 decimal digits and must be further than 1e-4 from the float32 conv,
or the tolerance could not tell the two apart."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepliif_tpu.ops import fused_resblock as FR_jax
from deepliif_tpu_torch.ops import fused_resblock as FR

Y_TOL = 1e-4
STATS_REL = 1e-5
CUDA_STATS_REL = 1e-4
SHAPES = [(2, 32, 32, 256), (1, 18, 30, 40)]


def _inputs(shape, affine, seed=0, w_std=0.02):
    rng = np.random.default_rng(seed)
    s, _, _, c = shape
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, w_std, (3, 3, c, c)).astype(np.float32)
    sc = bi = None
    if affine:
        sc = (1 + 0.1 * rng.normal(0, 1, (s, c))).astype(np.float32)
        bi = (0.1 * rng.normal(0, 1, (s, c))).astype(np.float32)
    return x, w, sc, bi


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _stats_rel(got, ref):
    return max(float(np.abs(got[:, q] - ref[:, q]).max()
                     / np.abs(ref[:, q]).max()) for q in range(2))


@pytest.fixture(scope='module', autouse=True)
def _torch_threads():
    # beside the suite's xdist workers torch's thread pool oversubscribes
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('shape', SHAPES, ids=['c256', 'ragged'])
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine_relu'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_split_tf32_matches_jax_and_float32(shape, affine, padding):
    x, w, sc, bi = _inputs(shape, affine)
    # JAX's float32 kernel takes row chunks of at most 8 dividing H
    chunk = 16 if shape[1] % 8 == 0 else 6
    y_jax, st_jax = FR_jax.conv3x3_stats(
        jnp.asarray(x), jnp.asarray(w), padding=padding, in_scale=_j(sc),
        in_bias=_j(bi), in_relu=affine, chunk_rows=chunk, interpret=True)
    y_jax, st_jax = np.asarray(y_jax), np.asarray(st_jax)
    kw = dict(padding=padding, in_scale=_t(sc), in_bias=_t(bi),
              in_relu=affine)
    y3, st3 = FR.conv3x3_stats_split_tf32_reference(_t(x), _t(w), **kw)
    y32, st32 = FR.conv3x3_stats_reference(_t(x), _t(w), **kw)
    y1, _ = FR.conv3x3_stats_split_tf32_reference(_t(x), _t(w), products=1,
                                                  **kw)
    assert y3.shape == x.shape and y3.dtype == torch.float32
    assert np.abs(y3.numpy() - y_jax).max() < Y_TOL
    assert _stats_rel(st3.numpy(), st_jax) < STATS_REL
    assert (y3 - y32).abs().max().item() < Y_TOL
    assert _stats_rel(st3.numpy(), st32.numpy()) < STATS_REL
    # the control: TF32 alone misses the float32 tolerance
    assert (y1 - y32).abs().max().item() > Y_TOL


def _tf32_exact(v):
    """float32 v rounded to TF32 in exact rational arithmetic: to the
    nearest multiple of its TF32 unit (2^(e - 10) in binade [2^e, 2^(e+1)),
    2^-136 below 2^-126), ties away from zero; infinity past the largest
    float32 binade."""
    if v == 0 or not np.isfinite(v):
        return np.float32(v)
    a = Fraction(abs(float(v)))
    e = max(a.numerator.bit_length() - a.denominator.bit_length(), -126)
    while Fraction(2) ** e > a:
        e -= 1
    while Fraction(2) ** (e + 1) <= a:
        e += 1
    unit = Fraction(2) ** (max(e, -126) - 10)
    n = a / unit
    r = int(n) + (1 if n - int(n) >= Fraction(1, 2) else 0)
    out = r * unit
    if out >= Fraction(2) ** 128:
        return np.float32(np.copysign(np.inf, v))
    return np.float32(np.copysign(float(out), v))


def _bits(*u):
    return np.array(u, dtype=np.uint32).view(np.float32)


def test_tf32_round_matches_exact_rounding_on_edge_values():
    one = 0x3F800000
    edges = np.concatenate([
        _bits(one, one + 0x1000, one + 0x0FFF, one + 0x1001, one + 0x3000,
              one + 0x2000 + 0x1000, 0x3FFFF000, 0x407FF000),   # ties, carries
        -_bits(one + 0x1000, one + 0x3000),                     # negative ties
        _bits(0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0x7F7FE000,
              0x7F7FF001),                                      # near overflow
        _bits(0x00000001, 0x00000FFF, 0x00001000, 0x00001001, 0x00003000,
              0x007FFFFF, 0x007FF000, 0x00800000, 0x00801000),  # subnormals
        np.array([0.0, -0.0], np.float32)])
    rng = np.random.default_rng(3)
    rand = (rng.normal(0, 1, 500) * 10.0 ** rng.integers(-30, 30, 500)
            ).astype(np.float32)
    vals = np.concatenate([edges, rand])
    got = FR.tf32_round(torch.from_numpy(vals)).numpy()
    want = np.array([_tf32_exact(v) for v in vals], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # kept bits only: the low 13 bits of every finite result are zero
    assert not (got.view(np.uint32)[np.isfinite(got)] & 0x1FFF).any()
    special = torch.tensor([float('inf'), -float('inf'), float('nan')])
    out = FR.tf32_round(special)
    assert out[0] == float('inf') and out[1] == -float('inf')
    assert torch.isnan(out[2])


def _blocks(rng, n, c):
    def norm():
        return {'scale': torch.from_numpy(
                    (1 + 0.02 * rng.normal(0, 1, (c,))).astype(np.float32)),
                'bias': torch.from_numpy(
                    (0.01 * rng.normal(0, 1, (c,))).astype(np.float32))}
    return [{'w1': torch.from_numpy(
                 rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32)),
             'norm1': norm(),
             'w2': torch.from_numpy(
                 rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32)),
             'norm2': norm()} for _ in range(n)]


@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_split_tf32_chain_within_float32_tolerance(padding):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 256))
                         .astype(np.float32))
    blocks = _blocks(rng, 9, 256)
    want = FR.resblock_chain_reference(x, blocks, padding=padding)
    got = FR._chain(lambda h, b, j, **kw: FR.conv3x3_stats_split_tf32_reference(
        h, b[f'w{j}'], padding=padding, **kw), x, blocks, 1e-5)
    assert (got - want).abs().max().item() < Y_TOL


# ---- the kernel on the card: within the float32 tolerance of its plain
# version at the flagship trunk's shape (at batch 2) and at ragged shapes
# (H, W not multiples of its 16 x 16 tile, C a multiple of its 8-channel
# stage but not of its 64-channel block), byte-equal run to run and for a
# sample alone as in the batch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 128, 128, 256), (2, 37, 45, 40),
                                   (1, 18, 130, 72)],
                         ids=['flagship', 'ragged', 'ragged_wide'])
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine_relu'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_cuda_f32_kernel_matches_plain_version(cuda, shape, affine, padding):
    x, w, sc, bi = _inputs(shape, affine, seed=5)
    xc, wc = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    kw = dict(padding=padding, in_relu=affine,
              in_scale=None if sc is None else torch.from_numpy(sc).cuda(),
              in_bias=None if bi is None else torch.from_numpy(bi).cuda())
    n0 = FR.conv3x3_stats.launches
    y, st = FR.conv3x3_stats(xc, wc, **kw)
    assert FR.conv3x3_stats.launches == n0 + 1
    y_ref, st_ref = FR.conv3x3_stats_reference(xc, wc, **kw)
    assert (y - y_ref).abs().max().item() < Y_TOL
    assert _stats_rel(st.cpu().numpy(), st_ref.cpu().numpy()) < CUDA_STATS_REL
    y2, st2 = FR.conv3x3_stats(xc, wc, **kw)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    if shape[0] > 1:
        alone = {k: (v[1:2].contiguous() if k in ('in_scale', 'in_bias')
                     and v is not None else v) for k, v in kw.items()}
        y1, st1 = FR.conv3x3_stats(xc[1:2].contiguous(), wc, **alone)
        assert torch.equal(y1[0], y[1]) and torch.equal(st1[0], st[1])


@pytest.mark.cuda
def test_cuda_f32_kernel_refuses_channels_not_multiple_of_8(cuda):
    x, w, _, _ = _inputs((1, 8, 8, 12), False)
    with pytest.raises(ValueError, match='C % 8 == 0'):
        FR.conv3x3_stats(torch.from_numpy(x).cuda(),
                         torch.from_numpy(w).cuda())
