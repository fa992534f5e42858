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


# ---- the tensor-core kernel (csrc/tail_s2d.cu) on the card against its
# plain version: H and W not multiples of its 8 x 58 output tile (the block
# form needs H, W % 8, so its rows are whole tiles), Cin 8 (half of a
# 16-channel stage), 16 and 64, both paddings, with and without the
# affine + ReLU. The same bounds as above (block: one bf16 ulp; fused: one
# ulp of each value it rounds), byte-equal run to run and a sample alone
# vs in the batch.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_inputs(shape, affine, seed):
    rng = np.random.default_rng(seed)
    s, _, _, cin = shape
    def card(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()
    x = card(rng.normal(0, 1, shape)).to(torch.bfloat16)
    w = card(rng.normal(0, 0.05, (7, 7, cin, COUT))).to(torch.bfloat16)
    b = card(rng.normal(0, 0.1, (COUT,))).to(torch.bfloat16)
    kw = dict(in_scale=card(1 + 0.1 * rng.normal(0, 1, (s, cin))),
              in_bias=card(0.1 * rng.normal(0, 1, (s, cin))),
              in_relu=True) if affine else {}
    return x, w, b, kw


CUDA_CASES = [pytest.param(form, shape, padding, affine,
                           id=f'{form}-{"x".join(map(str, shape))}-{padding}'
                              f'-{AFFINE_ID[affine]}')
              for form, shape, affine in (
                  ('fused', (2, 37, 70, 8), True),
                  ('fused', (2, 19, 131, 16), True),
                  ('fused', (2, 64, 64, 64), True),
                  ('fused', (2, 21, 59, 16), False),
                  ('block', (2, 40, 120, 64), True),
                  ('block', (2, 16, 72, 16), True),
                  ('block', (2, 24, 64, 8), False))
              for padding in ('zero', 'reflect')]


@pytest.mark.cuda
@pytest.mark.parametrize('form, shape, padding, affine', CUDA_CASES)
def test_cuda_tail_kernel_matches_plain_version(cuda, form, shape, padding,
                                                affine):
    x, w, b, kw = _card_inputs(shape, affine, seed=7)
    kw['padding'] = padding
    if form == 'fused':
        def run(xx, **k):
            return FS.tail_s2d_fused(xx, w, b, **k)
        counter = FS.tail_s2d_fused
        ref = FS.tail_s2d_fused_reference(x, w, b, **kw).float()
        c = FS._tail_conv(x, w, kw.get('in_scale'), kw.get('in_bias'),
                          bool(kw.get('in_relu')), padding).to(
                              torch.bfloat16).float()
        s = (c + b.float()[None, :, None, None]).to(torch.bfloat16).float()
        tol = BF16_ULP * (c.abs() + s.abs() + ref.abs())
    else:
        def run(xx, **k):
            return FS.tail_s2d_block(xx, w, **k)
        counter = FS.tail_s2d_block
        ref = FS.tail_s2d_block_reference(x, w, **kw).float()
        tol = BF16_ULP * ref.abs()
    n0 = counter.launches
    y = run(x, **kw)
    assert counter.launches == n0 + 1
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    assert bool(((y.float() - ref).abs() <= tol + 1e-6).all())
    assert torch.equal(y, run(x, **kw))
    alone = {k: (v[1:2].contiguous() if isinstance(v, torch.Tensor) else v)
             for k, v in kw.items()}
    assert torch.equal(run(x[1:2].contiguous(), **alone)[0], y[1])
