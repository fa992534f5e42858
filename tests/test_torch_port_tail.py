"""The port's translator tail (labs/fused_stages.py ``tail_s2d_fused`` and
``tail_s2d_block``: affine -> ReLU -> 3-px pad -> 7x7 conv, then bias and
tanh) against the JAX package's space-to-depth Pallas kernel in interpret
mode, on the CPU. Inputs are made with numpy from a seed and handed to both.

- Both paddings (reflect; zero, which pads after the affine), at float32
  and bfloat16: the block form with and without the input affine + ReLU,
  the fused form with it (as the translator calls it; the two forms run
  the same conv, and each JAX call costs about 2 s of tracing), on
  (2, 64, 64, 16) -> 3 as the JAX package's own test
  (tests/test_fused_stages.py). float32: within 1e-4, that test's
  tolerance. bfloat16, block form (the conv rounded to bf16): within one
  bf16 ulp (both round a float32 sum of the same exact products, taken in
  another order). bfloat16, fused form: within one bf16 ulp of each of the
  three values it rounds, |c| + |c + b| + |y| (c the rounded conv, y the
  output): a conv one ulp apart moves the bf16 sum with the bias by up to
  that ulp and tanh passes it on, scaled by at most 1.
- The two forms agree with each other: the fused form is tanh(bf16(block
  + b)) with the block layout undone, exactly.
- The wrappers raise where there is no kernel and no plain version: a
  device other than cpu or cuda, an unknown padding, a block form with H or
  W not a multiple of 8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepliif_tpu.labs import fused_stages as FS_jax
from deepliif_tpu_torch.labs import fused_stages as FS

SHAPE, COUT = (2, 64, 64, 16), 3
F32_TOL = 1e-4
BF16_ULP = 2.0 ** -7
AFFINE_ID = {False: 'plain', True: 'affine_relu'}


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Torch on one thread in this module: small convs beside the suite's
    other workers oversubscribe a thread pool per op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _inputs(dtype, affine, seed=0):
    """(torch args, torch kwargs, jax args, jax kwargs) of one tail call:
    x, w, b and the optional (S, Cin) norm affine with ReLU."""
    rng = np.random.default_rng(seed)
    s, _, _, cin = SHAPE
    xt, xj = _cast(rng.normal(0, 1, SHAPE).astype(np.float32), dtype)
    wt, wj = _cast(rng.normal(0, 0.1, (7, 7, cin, COUT)).astype(np.float32),
                   dtype)
    b = rng.normal(0, 0.1, (COUT,)).astype(np.float32)
    sc = (1 + 0.1 * rng.normal(0, 1, (s, cin))).astype(np.float32)
    bi = (0.1 * rng.normal(0, 1, (s, cin))).astype(np.float32)
    kw_t = dict(in_scale=torch.from_numpy(sc), in_bias=torch.from_numpy(bi),
                in_relu=True) if affine else {}
    kw_j = dict(in_scale=jnp.asarray(sc), in_bias=jnp.asarray(bi),
                in_relu=True) if affine else {}
    return (xt, wt, torch.from_numpy(b)), kw_t, (xj, wj, jnp.asarray(b)), kw_j


def _unblock(y):
    """The JAX block layout (S, H/8, W/8, 64 Cout) -> (S, H, W, Cout)."""
    s_n, hb, wb, _ = y.shape
    return (y.reshape(s_n, hb, wb, 8, 8, COUT).transpose(0, 1, 3, 2, 4, 5)
            .reshape(s_n, 8 * hb, 8 * wb, COUT))


CASES = [pytest.param(form, padding, affine, dtype,
                      id='-'.join((form, padding, AFFINE_ID[affine], dtype)))
         for form in ('block', 'fused') for padding in ('reflect', 'zero')
         for affine in (False, True) for dtype in ('float32', 'bfloat16')
         if form == 'block' or affine]


@pytest.mark.parametrize('form, padding, affine, dtype', CASES)
def test_tail_matches_jax(form, padding, affine, dtype):
    (xt, wt, bt), kw_t, (xj, wj, bj), kw_j = _inputs(dtype, affine)
    if form == 'block':
        ref = _np(FS_jax.tail_s2d_block(xj, wj, padding=padding,
                                        interpret=True, **kw_j))
        y = FS.tail_s2d_block(xt, wt, padding=padding, **kw_t)
        assert y.dtype == xt.dtype and tuple(y.shape) == ref.shape
        tol = BF16_ULP * np.abs(ref)
    else:
        ref = _np(FS_jax.tail_s2d_fused(xj, {'w': wj, 'b': bj},
                                        padding=padding, interpret=True,
                                        **kw_j))
        y = FS.tail_s2d_fused(xt, wt, bt, padding=padding, **kw_t)
        assert y.dtype == xt.dtype
        assert tuple(y.shape) == (SHAPE[0], COUT) + SHAPE[1:3]
        y = y.permute(0, 2, 3, 1)
        c = _unblock(_np(FS.tail_s2d_block(xt, wt, padding=padding, **kw_t)))
        s = _np(torch.from_numpy(c).to(xt.dtype) + bt.to(xt.dtype))
        tol = BF16_ULP * (np.abs(c) + np.abs(s) + np.abs(ref))
    d = np.abs(_np(y) - ref)
    if dtype == 'float32':
        assert d.max() <= F32_TOL, d.max()
    else:
        assert (d <= tol + 1e-6).all(), (d - tol).max()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_tail_fused_is_tanh_of_block_plus_bias(padding, dtype):
    (xt, wt, bt), kw_t, _, _ = _inputs(dtype, True, seed=1)
    blocks = FS.tail_s2d_block(xt, wt, padding=padding, **kw_t)
    want = torch.tanh(torch.from_numpy(_unblock(blocks.float().numpy()))
                      .to(xt.dtype) + bt.to(xt.dtype)).permute(0, 3, 1, 2)
    got = FS.tail_s2d_fused(xt, wt, bt, padding=padding, **kw_t)
    assert torch.equal(got, want)
    # no bias: tanh of the conv alone
    got = FS.tail_s2d_fused(xt, wt, None, padding=padding, **kw_t)
    assert torch.equal(got, torch.tanh(torch.from_numpy(_unblock(
        blocks.float().numpy())).to(xt.dtype)).permute(0, 3, 1, 2))


def test_tail_wrappers_raise():
    (xt, wt, bt), _, _, _ = _inputs('bfloat16', False)
    meta = xt.to('meta')
    with pytest.raises(ValueError, match='runs on cpu or cuda'):
        FS.tail_s2d_fused(meta, wt.to('meta'), bt.to('meta'))
    with pytest.raises(ValueError, match='runs on cpu or cuda'):
        FS.tail_s2d_block(meta, wt.to('meta'))
    with pytest.raises(ValueError, match='padding'):
        FS.tail_s2d_fused(xt, wt, bt, padding='replicate')
    with pytest.raises(ValueError, match='H, W % 8'):
        FS.tail_s2d_block(xt[:, :60], wt)
    # the fused form takes any H, W (the kernel masks a ragged edge)
    y = FS.tail_s2d_fused(xt[:, :60, :52].contiguous(), wt, bt)
    assert tuple(y.shape) == (SHAPE[0], COUT, 60, 52)
