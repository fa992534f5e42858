"""The int8 convs of int8 scope 'all' (``ops.conv_int8``, kernel
``csrc/conv_s8.cu``) and the int8 route of ``nets.layers`` against the JAX
package's ``layers.conv2d`` / ``conv_transpose2d`` on quantized params, on
the CPU: each conv kind of the flagship's int8 forward, static and dynamic
scales, the dynamic route's 256^2 spatial gate, and the plain conv at its
worst case against an int64 reference. The card-only tests hold the kernel
bit-equal to its plain version.

Tolerances: none. The quantized inputs are equal, the int32 sums exact in
both packages, and the epilogue (one float32 product, the rounding to
bf16, the bias added in bf16) rounds at the same points, so the bf16
outputs are bit-equal (measured: equal in every case).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu.nets import layers as L_jax
from deepliif_tpu_torch.nets import layers as L
from deepliif_tpu_torch.ops import conv_int8 as C, quant
from deepliif_tpu_torch.utils.checkpoints import weight_from_hwio


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (kind, k, stride, padding, output_padding, pad first): the translators'
# down convs and up conv-transposes, the U-Nets' down convs and
# conv-transposes, the unfused trunk's zero and reflect convs, the
# attention U-Net's 1x1 gate convs
KINDS = {'conv1x1_s1': ('conv', 1, 1, 0, 0, None),
         'conv3x3_s2': ('conv', 3, 2, 1, 0, None),
         'convT3x3_s2_op1': ('convT', 3, 2, 1, 1, None),
         'conv4x4_s2': ('conv', 4, 2, 1, 0, None),
         'convT4x4_s2_op0': ('convT', 4, 2, 1, 0, None),
         'conv3x3_s1_zero': ('conv', 3, 1, 1, 0, None),
         'conv3x3_s1_reflect': ('conv', 3, 1, 0, 0, 'reflect')}


def _bf16(a):
    """numpy float32 -> (jnp bf16 NHWC, torch bf16 NCHW view of NHWC
    memory)."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    return j, t


def _params(rng, kind, k, cin, cout, static, bias=False):
    """The JAX quantized param dict and the port's Int8Conv of one conv
    (HWIO weights at the reference init)."""
    w = rng.normal(0, 0.02, (k, k, cin, cout)).astype(np.float32)
    p = {'w': jnp.asarray(w)}
    if bias:
        p['b'] = jnp.asarray(rng.normal(0, 0.1, cout).astype(np.float32))
    scale = rng.uniform(0.5, 4.0, cin).astype(np.float32).tolist() \
        if static else None
    pq = L_jax.quantize_conv_tree_int8(
        {'c': p}, act_scales={'c': scale} if static else None)['c']
    wt = torch.from_numpy(w)
    qc = quant.quantize_conv(weight_from_hwio(wt, kind), wt, scale,
                             torch.bfloat16)
    return pq, qc


def _jax_conv(x, p, kind, k, s, pad, op, pre):
    if pre:
        x = L_jax.pad2d(x, 1, pre)
    if kind == 'conv':
        return L_jax.conv2d(x, p, s, pad)
    return L_jax.conv_transpose2d(x, p, s, pad, op)


def _port_conv(x, w, kind, k, s, pad, op, pre, bias=None):
    if pre:
        x = L.pad2d(x, 1, pre)
    if kind == 'conv':
        return L.conv2d(x, w, bias, s, pad)
    return L.conv_transpose2d(x, w, bias, s, pad, op)


@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
@pytest.mark.parametrize('name', list(KINDS))
def test_int8_conv_matches_jax(name, static):
    """Quantized input, int32 sums and bf16 output of each conv kind, on
    the port's plain route, against the JAX package on the same bf16
    input (eager, every op rounds as the port's do)."""
    kind, k, s, pad, op, pre = KINDS[name]
    rng = np.random.default_rng(3)
    n, h, w, cin, cout = 2, 12, 10, 16, 24
    xj, xt = _bf16(np.maximum(rng.normal(0, 1.5, (n, h, w, cin)), -0.5))
    pq, qc = _params(rng, kind, k, cin, cout, static, bias=True)
    bj = pq['b']
    bt = torch.from_numpy(np.array(bj)).to(torch.bfloat16)
    with jax.disable_jit():
        ref = _jax_conv(xj, pq, kind, k, s, pad, op, pre)
        xin = L_jax.pad2d(xj, 1, pre) if pre else xj
        q_ref, _ = L_jax._quant_act(xin, pq)
    got = _port_conv(xt, qc, kind, k, s, pad, op, pre, bt)
    xin_t = L.pad2d(xt, 1, pre) if pre else xt
    q, _ = L.int8_input(xin_t, qc)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    # the int32 sums: |acc| < 2^24 here, so float32 holds them exactly
    ones = torch.ones(cout)
    if kind == 'conv':
        acc = C.conv2d_int8_reference(q, qc.w_q, ones, None, s, pad,
                                      torch.float32)
        acc_ref = jax.lax.conv_general_dilated(
            q_ref, pq['w_q'], (s, s), [(pad, pad)] * 2,
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
            preferred_element_type=jnp.int32)
    else:
        acc = C.conv_transpose2d_int8_reference(q, qc.w_q, ones, None, s, pad,
                                                op, torch.float32)
        lo, hi = k - 1 - pad, k - 1 - pad + op
        acc_ref = jax.lax.conv_general_dilated(
            q_ref, pq['w_q'], (1, 1), [(lo, hi)] * 2, lhs_dilation=(s, s),
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
            preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64),
                                  np.asarray(acc_ref).astype(np.int64))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize('hw, int8', [((257, 256), False), ((256, 256), True)],
                         ids=['past_gate', 'at_gate'])
def test_dynamic_spatial_gate(hw, int8):
    """Dynamic scales: an input of more than 256^2 pixels takes the float
    route in both packages (the port's output equals its float conv), one
    of 256^2 the int8 route (it does not); static scales take int8 at any
    size."""
    rng = np.random.default_rng(4)
    xj, xt = _bf16(rng.normal(0, 1, (1, *hw, 16)).astype(np.float32))
    pq, qc = _params(rng, 'conv', 4, 16, 16, static=False)
    with jax.disable_jit():
        ref = L_jax.conv2d(xj, pq, 2, 1)
        ref_float = L_jax.conv2d(xj, {'w': pq['w']}, 2, 1)
    got = L.conv2d(xt, qc, None, 2, 1)
    got_float = L.conv2d(xt, qc.w, None, 2, 1)
    assert np.array_equal(np.asarray(ref), np.asarray(ref_float)) != int8
    assert torch.equal(got, got_float) != int8
    if int8:
        np.testing.assert_array_equal(
            got.permute(0, 2, 3, 1).float().numpy(),
            np.asarray(ref.astype(jnp.float32)))
    _, qs = _params(rng, 'conv', 4, 16, 16, static=True)
    assert not torch.equal(L.conv2d(xt, qs, None, 2, 1),
                           L.conv2d(xt, qs.w, None, 2, 1))


def _valid_conv_int64(xp, w):
    """numpy int64 valid conv, stride 1: xp (H, W, Cin), w (KH, KW, Cin,
    Cout)."""
    kh, kw = w.shape[:2]
    ho, wo = xp.shape[0] - kh + 1, xp.shape[1] - kw + 1
    return np.stack([np.stack([np.einsum('hwc,hwco->o',
                                         xp[i:i + kh, j:j + kw], w)
                               for j in range(wo)]) for i in range(ho)])


@pytest.mark.parametrize('kind', ['conv', 'convT'])
def test_plain_int8_conv_worst_case_exact(kind):
    """The plain conv's float64 sums at the flagship's largest K (16 taps x
    1024 channels for the 4x4 conv, 4 taps x 1024 for the conv-transpose)
    and values +-127 equal an int64 numpy reference: all of one sign (the
    largest |sum|, 127^2 x 16384 for the conv), and random signs."""
    rng = np.random.default_rng(5)
    cin, cout = 1024, 16
    for worst in (True, False):
        if worst:
            x = np.full((1, 4, 4, cin), 127, np.int8)
            w = np.full((4, 4, cin, cout), -127, np.int8)
        else:
            x = rng.choice(np.array([-127, 127], np.int8), (1, 4, 4, cin))
            w = rng.choice(np.array([-127, 127], np.int8), (4, 4, cin, cout))
        x64, w64 = x[0].astype(np.int64), w.astype(np.int64)
        ones = torch.ones(cout)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        if kind == 'conv':
            # 4x4 valid over the 4x4 input: one pixel summing all products
            got = C.conv2d_int8_reference(xt, wt, ones, None, 1, 0,
                                          torch.float32)[0]
            want = _valid_conv_int64(x64, w64)
        else:
            got = C.conv_transpose2d_int8_reference(xt, wt, ones, None, 2, 1,
                                                    0, torch.float32)[0]
            xd = np.zeros((7, 7, cin), np.int64)
            xd[::2, ::2] = x64
            want = _valid_conv_int64(np.pad(xd, ((2, 2), (2, 2), (0, 0))),
                                     w64)
        if worst and kind == 'conv':
            assert want.min() == -127 ** 2 * 16 * 1024
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the fused entries run their plain versions (the
    quantize, then the float64 conv) and launch nothing; the launch itself
    refuses a CPU tensor."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (2, 6, 6, 16)).astype(
        np.float32)).to(torch.bfloat16)
    n0, m0 = C.conv_s8.launches, C.sample_absmax.launches
    for static in (False, True):
        _, qc = _params(rng, 'conv', 3, 16, 8, static)
        _, qt = _params(rng, 'convT', 3, 16, 8, static)
        assert torch.equal(C.conv2d_s8(x, qc, None, 2, 1),
                           C.conv2d_s8_reference(x, qc, None, 2, 1))
        assert torch.equal(C.conv_transpose2d_s8(x, qt, None, 2, 1, 1),
                           C.conv_transpose2d_s8_reference(x, qt, None, 2, 1,
                                                           1))
        with pytest.raises(ValueError, match='cuda'):
            C.conv_s8(x, qc, None, stride=1, dil=1, pad=(1, 1),
                      out_hw=(6, 6))
    assert torch.equal(C.sample_absmax(x), x.float().abs().amax((1, 2, 3)))
    assert (C.conv_s8.launches, C.sample_absmax.launches) == (n0, m0)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


# (kind, x shape, C_out, k, stride, padding, output_padding): each kind at
# odd sizes (H, W not multiples of a tile, M not of the 128 or 256 rows of
# an item, C_out not of its channel block, C_in not of the 32-channel
# step), and the U-Nets' 1 x 1 and 2 x 2 levels (split K); the attention
# U-Net's 1x1 gate convs at a ragged grid, its 256^2 level's widths and
# its innermost 4 x 4 x 512 gate
CUDA_CASES = [
    ('conv', (2, 37, 45, 128), 64, 1, 1, 0, 0),
    ('conv', (2, 64, 64, 64), 32, 1, 1, 0, 0),
    ('conv', (2, 4, 4, 512), 512, 1, 1, 0, 0),
    ('conv', (2, 37, 45, 16), 24, 3, 2, 1, 0),
    ('conv', (3, 19, 33, 48), 72, 4, 2, 1, 0),
    ('conv', (2, 2, 2, 512), 512, 4, 2, 1, 0),
    ('conv', (2, 21, 18, 80), 8, 3, 1, 1, 0),
    ('conv', (2, 23, 17, 32), 40, 3, 1, 0, 0),
    ('convT', (2, 13, 22, 48), 24, 3, 2, 1, 1),
    ('convT', (2, 1, 1, 512), 512, 4, 2, 1, 0),
    ('convT', (3, 9, 14, 144), 64, 4, 2, 1, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
@pytest.mark.parametrize('case', CUDA_CASES,
                         ids=['-'.join(map(str, (c[0], *c[1], c[2], c[3])))
                              for c in CUDA_CASES])
def test_cuda_conv_s8_bit_equal_to_plain(cuda, case, static):
    """The kernel (quantize in the load, the conv, the epilogue) equals its
    plain version bit for bit, with and without the bias, run to run, and
    for one sample alone against the same sample in the batch."""
    kind, shape, cout, k, s, pad, op = case
    rng = np.random.default_rng(8)
    cin = shape[3]
    x = torch.from_numpy(rng.normal(0, 1.5, shape).astype(np.float32)).to(
        torch.bfloat16).cuda()
    _, qc = _params(rng, kind, k, cin, cout, static)
    qc = _to_cuda(qc)
    bias = torch.from_numpy(rng.normal(0, 1, cout).astype(np.float32)).to(
        torch.bfloat16).cuda()
    fn, ref, args = ((C.conv2d_s8, C.conv2d_s8_reference, (s, pad))
                     if kind == 'conv' else
                     (C.conv_transpose2d_s8, C.conv_transpose2d_s8_reference,
                      (s, pad, op)))
    for b in (None, bias):
        n0 = C.conv_s8.launches
        y = fn(x, qc, b, *args)
        assert C.conv_s8.launches == n0 + 1
        want = ref(x, qc, b, *args)
        assert y.dtype == torch.bfloat16 and y.shape == want.shape
        assert torch.equal(y, want)
        assert torch.equal(y, fn(x, qc, b, *args))
    one = fn(x[1:2].contiguous(), qc, None, *args)
    assert torch.equal(one[0], fn(x, qc, None, *args)[1])


def _to_cuda(qc):
    return quant.Int8Conv(*(None if t is None else t.cuda() for t in (
        qc.w, qc.w_q, qc.w_s, qc.w_pk, qc.a_s, qc.inv_a, qc.inv_c)))


@pytest.mark.cuda
def test_cuda_conv_s8_refuses(cuda):
    """Shapes and types the kernel does not take raise, with no launch."""
    rng = np.random.default_rng(9)
    n0 = C.conv_s8.launches
    _, qc = _params(rng, 'conv', 3, 20, 8, True)
    x = torch.zeros((1, 4, 4, 20), dtype=torch.bfloat16, device='cuda')
    with pytest.raises(ValueError, match='C_in % 8'):
        C.conv2d_s8(x, _to_cuda(qc))
    _, qc = _params(rng, 'conv', 3, 24, 8, True)
    x = torch.zeros((1, 4, 4, 24), device='cuda')
    with pytest.raises(TypeError):
        C.conv2d_s8(x, _to_cuda(qc))
    assert C.conv_s8.launches == n0
