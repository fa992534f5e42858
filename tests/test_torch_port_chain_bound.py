"""The bf16 9-block chain bound of chip_smoke.py on the CPU: does it
separate sound trunk convs from faulty ones?

chip_smoke.py holds the bf16 trunk kernel's 9-block resblock chain to
accuracy against float32 (``within_chain_bound``: mean |delta| from the
float32 chain no more than ``CHAIN_F32_MARGIN`` times the plain bf16
chain's). Here the same function is fed chains through the plain conv's
variants at (2, 32, 32, 256), both paddings, inputs drawn with numpy as
chip_smoke.py draws its chain inputs (x N(0, 1), w N(0, 0.02), norm scale
N(1, 0.02), bias N(0, 0.01)):

- a float64 conv rounded once (``exact_conv``, another summation order
  than the plain version's, as a tensor-core kernel has) must pass;
- the plain conv rounded toward zero (``biased_conv``, a one-ulp bias)
  and the plain conv with every nonzero output moved one ulp up or down at
  random must fail.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from deepliif_tpu_torch.ops import fused_resblock as FR

SHAPE = (2, 32, 32, 256)
BLOCKS = 9


def one_ulp_everywhere(seed):
    """The plain bf16 conv with every nonzero output moved one bf16 ulp up
    or down, at random from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def conv(x, w, **kw):
        y, st = FR.conv3x3_stats_reference(x, w, **kw)
        bits = y.view(torch.int16)
        step = torch.randint(0, 2, y.shape, generator=gen,
                             dtype=torch.int16) * 2 - 1
        moved = torch.where(y != 0, bits + step, bits)
        return moved.view(torch.bfloat16), st
    return conv


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    s, h, w, c = SHAPE

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    def norm():
        return {'scale': t(rng.normal(1.0, 0.02, c)),
                'bias': t(rng.normal(0.0, 0.01, c))}
    x = t(rng.normal(0.0, 1.0, SHAPE)).to(torch.bfloat16)
    blocks = []
    for _ in range(BLOCKS):
        b = {'norm1': norm(), 'norm2': norm()}
        for j in (1, 2):
            b[f'w{j}'] = t(rng.normal(0.0, 0.02, (3, 3, c, c))).to(
                torch.bfloat16)
        blocks.append(b)
    return x, blocks


@functools.cache
def _accuracy(padding):
    torch.manual_seed(0)
    x, blocks = _inputs()
    return smoke.bf16_chain_accuracy(
        FR, x, blocks, padding, {'exact': smoke.exact_conv(FR),
                                 'toward_zero': smoke.biased_conv(FR),
                                 'one_ulp_everywhere': one_ulp_everywhere(1)})


@pytest.mark.parametrize('padding', ['zero', 'reflect'])
@pytest.mark.parametrize('variant,sound', [('exact', True),
                                           ('toward_zero', False),
                                           ('one_ulp_everywhere', False)])
def test_chain_bound_separates_sound_from_faulty_convs(padding, variant,
                                                       sound):
    dist, vs_plain = _accuracy(padding)
    assert smoke.within_chain_bound(dist, variant) == sound, dist
    if sound:
        # a sound conv also stays within the max bound against the plain
        # chain
        assert vs_plain[variant] <= smoke.BF16_CHAIN_MAX, vs_plain


def test_bf16_toward_zero_rounds_toward_zero():
    y = torch.tensor([1.0 + 2.0 ** -8, -(1.0 + 2.0 ** -8), 3.0 - 2.0 ** -10,
                      1.5, -0.0])
    got = smoke.bf16_toward_zero(y).float().tolist()
    assert got == [1.0, -1.0, 3.0 - 2.0 ** -6, 1.5, -0.0]
    # never away from zero, and less than one bf16 ulp below |x|
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 100, 10000)
                         .astype(np.float32))
    r = smoke.bf16_toward_zero(x).float()
    assert bool((r.abs() <= x.abs()).all())
    assert bool(((x.abs() - r.abs()) < 2.0 ** -7 * x.abs()).all())
