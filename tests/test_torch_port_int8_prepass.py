"""The int8 trunk conv's quantize pass, on the CPU: the plain pre-pass
(``quantize_blocks_int8_reference``: per-chunk int8 blocks that hold the
chunk's two halo rows, quantized at the consuming chunk's scale, and the
halo columns) put through a plain integer conv and the contract's dequant
gives ``conv3x3_stats_int8_reference``'s y bit for bit, static and dynamic,
for H = 16, 32 (two chunks) and 12 (one chunk of all of H). The ``cuda``
cases hold the s8 kernel to its plain version on the card at ragged shapes:
y bit-equal (int32 sums are exact and the rounding points fixed), stats
within 1e-5 of the largest stat of their kind (chip_smoke.INT8_STATS_TOL:
float32 sums in another order)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepliif_tpu_torch.ops import fused_resblock as FR, quant

INT8_STATS_REL = 1e-5


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    s, _, _, c = shape
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        torch.bfloat16)
    wq, ws = quant.quantize_conv_int8(torch.from_numpy(
        rng.normal(0, 0.02, (3, 3, c, c)).astype(np.float32)))
    inv_a = torch.from_numpy((127.0 / (2.0 + 2.0 * rng.random(c)))
                             .astype(np.float32))
    sc = torch.from_numpy((1 + 0.1 * rng.normal(0, 1, (s, c)))
                          .astype(np.float32))
    bi = torch.from_numpy((0.1 * rng.normal(0, 1, (s, c))).astype(np.float32))
    return x, wq, ws, inv_a, sc, bi


def _stats_rel(got, ref):
    return max(((got[:, q] - ref[:, q]).abs().max()
                / ref[:, q].abs().max()).item() for q in range(2))


@pytest.mark.parametrize('h', [16, 32, 12])
@pytest.mark.parametrize('dynamic', [False, True], ids=['static', 'dynamic'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_prepass_blocks_give_the_plain_int8_conv(h, dynamic, padding):
    shape = (2, h, 20, 24)
    x, wq, ws, inv_a, sc, bi = _case(shape, seed=h)
    kw = dict(padding=padding, in_scale=sc, in_bias=bi, in_relu=True,
              dynamic=dynamic)
    inv = None if dynamic else inv_a
    blocks, m = FR.quantize_blocks_int8_reference(x, inv, **kw)
    s, n_ch = blocks.shape[:2]
    ch = min(16, h)
    c = shape[3]
    assert blocks.shape == (s, h // ch, ch + 2, shape[2] + 2, c)
    assert blocks.dtype == torch.int8
    assert (m is not None) == dynamic
    # a valid 3x3 integer conv of each block: the chunk's int32 sums
    q = blocks.reshape(s * n_ch, ch + 2, shape[2] + 2, c).permute(0, 3, 1, 2)
    acc = F.conv2d(q.double(), wq.double().permute(3, 2, 0, 1))
    assert acc.abs().max() < 2 ** 31
    deq = ws.expand(s, n_ch, c)
    if dynamic:
        deq = deq * (m / torch.full_like(m, 127.0))[:, :, None]
    yf = (acc.float().reshape(s, n_ch, c, ch, shape[2])
          * deq[..., None, None])
    yf = yf.permute(0, 2, 1, 3, 4).reshape(s, c, h, shape[2])
    y = yf.to(torch.bfloat16).permute(0, 2, 3, 1)
    y_ref, _ = FR.conv3x3_stats_int8_reference(x, wq, ws, inv, **kw)
    assert torch.equal(y, y_ref)


def test_prepass_quantizes_halo_rows_at_the_consuming_chunks_scale():
    # one spike in chunk 1's first row: chunk 0 sees it as a halo row and
    # takes it as its max; the same row in chunk 1's block is that chunk's
    x, *_ = _case((1, 32, 8, 8), seed=7)
    x[0, 16, 3, 2] = 40.0
    x[0, 20, 5, 1] = -60.0
    blocks, m = FR.quantize_blocks_int8_reference(x, padding='zero',
                                                  dynamic=True)
    assert m[0, 0].item() == 40.0 and m[0, 1].item() == 60.0
    # padded row 17 is chunk 0's bottom halo (block row 17) and chunk 1's
    # first row (block row 1)
    assert blocks[0, 0, 17, 4, 2].item() == 127
    assert blocks[0, 1, 1, 4, 2].item() == round(40.0 * float(
        torch.tensor(127.0 / 60.0).to(torch.bfloat16)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 32, 45, 40), (1, 16, 130, 72),
                                   (1, 12, 30, 24)],
                         ids=['two_chunks', 'wide', 'one_short_chunk'])
@pytest.mark.parametrize('dynamic', [False, True], ids=['static', 'dynamic'])
@pytest.mark.parametrize('padding', ['reflect', 'zero'])
def test_cuda_s8_kernel_matches_plain_version(cuda, shape, dynamic, padding):
    x, wq, ws, inv_a, sc, bi = (t.cuda() for t in _case(shape, seed=11))
    kw = dict(padding=padding, in_scale=sc, in_bias=bi, in_relu=True,
              dynamic=dynamic)
    inv = None if dynamic else inv_a
    n0 = FR.conv3x3_stats_int8.launches
    y, st = FR.conv3x3_stats_int8(x, wq, ws, inv, **kw)
    assert FR.conv3x3_stats_int8.launches == n0 + 1
    y_ref, st_ref = FR.conv3x3_stats_int8_reference(x, wq, ws, inv, **kw)
    assert torch.equal(y, y_ref)
    assert _stats_rel(st, st_ref) < INT8_STATS_REL
    y2, st2 = FR.conv3x3_stats_int8(x, wq, ws, inv, **kw)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    if shape[0] > 1:
        y1, st1 = FR.conv3x3_stats_int8(
            x[1:2].contiguous(), wq, ws, inv,
            **dict(kw, in_scale=sc[1:2].contiguous(),
                   in_bias=bi[1:2].contiguous()))
        assert torch.equal(y1[0], y[1]) and torch.equal(st1[0], st[1])
