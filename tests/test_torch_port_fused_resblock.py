"""The port's fused resblock op (plain version on the CPU) against the JAX
Pallas kernel run in interpret mode, on the same numpy inputs.

Tolerances: y within 1e-4 absolute, the repo's f32 layer tolerance
(tests/test_fused_resblock.py); stats within 1e-5 of the largest stat of
their kind (two float32 sums over H*W pixels taken in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepliif_tpu.ops import fused_resblock as FR_jax
from deepliif_tpu_torch.ops import fused_resblock as FR

Y_TOL = 1e-4
STATS_REL = 1e-5


def _inputs(shape, affine, seed=0):
    rng = np.random.default_rng(seed)
    s, _, _, c = shape
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32)
    sc = bi = None
    if affine:
        sc = (1 + 0.1 * rng.normal(0, 1, (s, c))).astype(np.float32)
        bi = (0.1 * rng.normal(0, 1, (s, c))).astype(np.float32)
    return x, w, sc, bi


def _stats_rel(got, ref):
    # per kind (sum, sum of squares): max |delta| over the largest |ref|
    return max(float(np.abs(got[:, q] - ref[:, q]).max()
                     / np.abs(ref[:, q]).max()) for q in range(2))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize('shape', [(2, 32, 16, 8), (1, 16, 16, 256)],
                         ids=['small', 'c256'])
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine_relu'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_conv3x3_stats_matches_jax(shape, affine, padding):
    x, w, sc, bi = _inputs(shape, affine)
    y_ref, st_ref = FR_jax.conv3x3_stats(
        jnp.asarray(x), jnp.asarray(w), padding=padding, in_scale=_j(sc),
        in_bias=_j(bi), in_relu=affine, interpret=True)
    y, st = FR.conv3x3_stats(_t(x), _t(w), padding=padding, in_scale=_t(sc),
                             in_bias=_t(bi), in_relu=affine)
    assert y.shape == x.shape and st.shape == (shape[0], 2, shape[3])
    assert np.abs(y.numpy() - np.asarray(y_ref)).max() < Y_TOL
    assert _stats_rel(st.numpy(), np.asarray(st_ref)) < STATS_REL


def _blocks(rng, n, c):
    def norm():
        return {'scale': (1 + 0.02 * rng.normal(0, 1, (c,))).astype(np.float32),
                'bias': (0.01 * rng.normal(0, 1, (c,))).astype(np.float32)}
    return [{'w1': rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32),
             'norm1': norm(),
             'w2': rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32),
             'norm2': norm()} for _ in range(n)]


def _tree(blocks, conv):
    return [{k: ({kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else conv(v)) for k, v in b.items()} for b in blocks]


@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_resblock_chain_matches_jax(padding):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 32, 16, 8)).astype(np.float32)
    blocks = _blocks(rng, 2, 8)
    ref = FR_jax.resblock_chain(jnp.asarray(x), _tree(blocks, jnp.asarray),
                                padding=padding, interpret=True)
    got = FR.resblock_chain(torch.from_numpy(x), _tree(blocks, torch.from_numpy),
                            padding=padding)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < Y_TOL
    plain = FR.resblock_chain_reference(
        torch.from_numpy(x), _tree(blocks, torch.from_numpy), padding=padding)
    assert torch.equal(got, plain)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    x, w, _, _ = _inputs((1, 8, 8, 4), False)
    before = FR.conv3x3_stats.launches
    y, st = FR.conv3x3_stats(_t(x), _t(w), padding='zero')
    y_ref, st_ref = FR.conv3x3_stats_reference(_t(x), _t(w), padding='zero')
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    assert FR.conv3x3_stats.launches == before


def test_wrapper_rejects_other_devices_and_paddings():
    x, w, _, _ = _inputs((1, 8, 8, 4), False)
    with pytest.raises(ValueError):
        FR.conv3x3_stats(_t(x).to('meta'), _t(w).to('meta'))
    with pytest.raises(ValueError):
        FR.conv3x3_stats(_t(x), _t(w), padding='replicate')


@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_cuda_kernel_matches_plain_version(padding):
    """Kernel vs plain twin on the card (ragged H, W and C); skipped
    without CUDA. chip_smoke.py runs the same check at flagship shapes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    x, w, sc, bi = _inputs((2, 13, 21, 40), True)
    args = [torch.from_numpy(a).cuda() for a in (x, w, sc, bi)]
    y, st = FR.conv3x3_stats(args[0], args[1], padding=padding,
                             in_scale=args[2], in_bias=args[3], in_relu=True)
    y_ref, st_ref = FR.conv3x3_stats_reference(
        args[0], args[1], padding=padding, in_scale=args[2], in_bias=args[3],
        in_relu=True)
    assert (y - y_ref).abs().max().item() < Y_TOL
    assert _stats_rel(st.cpu().numpy(), st_ref.cpu().numpy()) < STATS_REL


# ---- the bfloat16 kernel (the tensor-core mainloop of
# csrc/conv3x3_wgmma.cuh at stride 1) against its plain version at ragged
# shapes: H, W not multiples of its 16 x 16 tile, C a multiple of 8 but not
# of its 16-channel stage or its 128-channel block, and one full block of
# 128 channels over 8 stages. y within one bf16 ulp (both round float32
# sums of the same exact products, in another order; 1e-6 absolute for
# outputs near zero), stats within 1e-4 of the largest stat of their kind
# (chip_smoke.py STATS_TOL), and a sample byte-equal alone and in the
# batch, run to run.

BF16_ULP = 2.0 ** -7
BF16_STATS_REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 37, 45, 40), (1, 18, 130, 72),
                                   (2, 24, 40, 128)])
@pytest.mark.parametrize('affine', [False, True], ids=['plain', 'affine_relu'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_cuda_bf16_kernel_matches_plain_version(cuda, shape, affine,
                                                 padding):
    x, w, sc, bi = _inputs(shape, affine, seed=3)
    xb = torch.from_numpy(x).cuda().to(torch.bfloat16)
    wb = torch.from_numpy(w).cuda().to(torch.bfloat16)
    kw = dict(padding=padding, in_relu=affine,
              in_scale=None if sc is None else torch.from_numpy(sc).cuda(),
              in_bias=None if bi is None else torch.from_numpy(bi).cuda())
    n0 = FR.conv3x3_stats.launches_bf16
    y, st = FR.conv3x3_stats(xb, wb, **kw)
    assert FR.conv3x3_stats.launches_bf16 == n0 + 1
    y_ref, st_ref = FR.conv3x3_stats_reference(xb, wb, **kw)
    d = (y.float() - y_ref.float()).abs()
    assert bool((d <= BF16_ULP * y_ref.float().abs() + 1e-6).all())
    assert _stats_rel(st.cpu().numpy(), st_ref.cpu().numpy()) < BF16_STATS_REL
    y2, st2 = FR.conv3x3_stats(xb, wb, **kw)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    if shape[0] > 1:
        alone = {k: (v[1:2].contiguous() if k in ('in_scale', 'in_bias')
                     and v is not None else v) for k, v in kw.items()}
        y1, st1 = FR.conv3x3_stats(xb[1:2].contiguous(), wb, **alone)
        assert torch.equal(y1[0], y[1]) and torch.equal(st1[0], st[1])
