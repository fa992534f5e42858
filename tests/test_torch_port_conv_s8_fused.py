"""The fused int8 conv entries (``ops.conv_int8.conv2d_s8`` /
``conv_transpose2d_s8``: the bf16 activation quantized in the kernel's
load, kernel ``csrc/conv_s8.cu``) on the CPU, against the JAX package and
against emulations of the kernel's arithmetic and addressing:

- the CPU route, given bf16 x, against JAX's ``layers.conv2d`` /
  ``conv_transpose2d`` int8 route on the same quantized params, for every
  kind the kernel takes, static per-tensor, static per-channel and dynamic
  scales;
- the kernel's per-element quantize (bf16x2 product or IEEE division, the
  clip, the round by adding 1.5 * 2^23, the byte of the sum; the slab
  mode's table of quantized values per sample) emulated against
  ``quant_act_static`` / ``quant_act_dynamic`` on adversarial values: exact
  .5 ties, values around +-127.5, bf16 extremes, zeros, a sample of zeros,
  and every finite bf16 value;
- the kernel's phases, taps and packed-weight addressing emulated in numpy:
  every element of the packed image read back at its (tap, step, column,
  byte) and column order, and the emulated implicit GEMM equal to the
  plain int8 conv.

The card-only tests hold the kernel to its plain version bit for bit.

Tolerances: none. Integers and bf16 values compared for equality.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu.nets import layers as L_jax
from deepliif_tpu_torch.ops import conv_int8 as C, quant
from deepliif_tpu_torch.utils.checkpoints import weight_from_hwio


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (kind, k, stride, padding, output_padding): the kernel's five kinds, the
# 3x3 stride 1 also at padding 0 (the unfused trunk after a reflect pad)
KINDS = {'conv3x3_s2': ('conv', 3, 2, 1, 0),
         'conv4x4_s2': ('conv', 4, 2, 1, 0),
         'convT3x3_s2_op1': ('convT', 3, 2, 1, 1),
         'convT4x4_s2_op0': ('convT', 4, 2, 1, 0),
         'conv3x3_s1_pad1': ('conv', 3, 1, 1, 0),
         'conv3x3_s1_pad0': ('conv', 3, 1, 0, 0)}
SCALES = ('static_tensor', 'static_channel', 'dynamic')


def _params(rng, kind, k, cin, cout, scales, bias=True):
    """The JAX quantized param dict and the port's Int8Conv of one conv."""
    w = rng.normal(0, 0.02, (k, k, cin, cout)).astype(np.float32)
    p = {'w': jnp.asarray(w)}
    if bias:
        p['b'] = jnp.asarray(rng.normal(0, 0.1, cout).astype(np.float32))
    scale = {'static_tensor': float(rng.uniform(1.0, 4.0)),
             'static_channel': rng.uniform(0.5, 4.0, cin).astype(
                 np.float32).tolist(),
             'dynamic': None}[scales]
    pq = L_jax.quantize_conv_tree_int8(
        {'c': p}, act_scales=None if scale is None else {'c': scale})['c']
    wt = torch.from_numpy(w)
    qc = quant.quantize_conv(weight_from_hwio(wt, kind), wt, scale,
                             torch.bfloat16)
    return pq, qc


def _fused(x, qc, bias, kind, s, pad, op, reference=False):
    if kind == 'conv':
        fn = C.conv2d_s8_reference if reference else C.conv2d_s8
        return fn(x, qc, bias, s, pad)
    fn = C.conv_transpose2d_s8_reference if reference else \
        C.conv_transpose2d_s8
    return fn(x, qc, bias, s, pad, op)


@pytest.mark.parametrize('scales', SCALES)
@pytest.mark.parametrize('name', list(KINDS))
def test_fused_entry_cpu_matches_jax(name, scales):
    """The CPU route of the fused entry (bf16 NHWC x and the Int8Conv)
    equals JAX's int8 conv route bit for bit (eager: every op rounds as the
    port's do)."""
    kind, k, s, pad, op = KINDS[name]
    rng = np.random.default_rng(11)
    n, h, w, cin, cout = 2, 11, 9, 48, 24
    x = np.maximum(rng.normal(0, 1.5, (n, h, w, cin)), -0.7).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    pq, qc = _params(rng, kind, k, cin, cout, scales)
    bt = torch.from_numpy(np.array(pq['b'])).to(torch.bfloat16)
    with jax.disable_jit():
        ref = (L_jax.conv2d(xj, pq, s, pad) if kind == 'conv' else
               L_jax.conv_transpose2d(xj, pq, s, pad, op))
    n0 = C.conv_s8.launches
    got = _fused(xt, qc, bt, kind, s, pad, op)
    assert C.conv_s8.launches == n0
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# -- the kernel's per-element arithmetic, emulated ---------------------------

MAGIC = 12582912.0   # 1.5 * 2^23


def _round_pair_bytes(p):
    """round_pair of csrc/conv_s8.cu on bf16 values p: clip to +-127 in
    bf16, add 1.5 * 2^23 in float32, the low byte of the sum's encoding."""
    p = torch.clamp(p, -127, 127)
    bits = (p.float() + MAGIC).view(torch.int32)
    return (bits & 0xff).to(torch.uint8).view(torch.int8)


def _kernel_quant_static(x, inv_c):
    """quant8<static>: the exact f32 product of the two bf16 values
    rounded once to bf16 (__hmul2_rn), then round_pair. x (N, H, W, C)."""
    p = (x.float() * inv_c.float()).to(torch.bfloat16)
    return _round_pair_bytes(p)


def _kernel_quant_dynamic(x):
    """The max pass (integer max of the bf16 magnitudes' bits), dyn_scale
    (IEEE division by 127, clamp 1e-12), bf16(s), then quant8<dynamic>: the
    IEEE f32 quotient, rounded to bf16, then round_pair."""
    mag = x.view(torch.int16).to(torch.int32) & 0x7fff
    amax = (mag.reshape(x.shape[0], -1).amax(dim=1) << 16).view(
        torch.float32)
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    sb = s.to(torch.bfloat16).float()
    p = (x.float() / sb[:, None, None, None]).to(torch.bfloat16)
    return _round_pair_bytes(p), s


def _adversarial(inv):
    """bf16 values whose product with inv (or quotient) lands on exact .5
    ties, around +-127.5, at the bf16 extremes, at zero: (N, 4, 4, 16)."""
    k = np.arange(-130, 131, dtype=np.float64)
    ties = np.concatenate([k + 0.5, k, k + 0.25, k - 0.49,
                           [126.5, 127.5, 128.5, -126.5, -127.5, -128.5]])
    vals = np.concatenate([ties / inv,
                           [3.3895e38, -3.3895e38, 1e-40, -1e-40, 0.0, -0.0,
                            9.2e-41, 1.0, -1.0, 2.5, -2.5, 65504.0]])
    vals = np.resize(vals, 2 * 4 * 4 * 16).astype(np.float32)
    return torch.from_numpy(vals).to(torch.bfloat16).reshape(2, 4, 4, 16)


@pytest.mark.parametrize('inv', [1.0, 0.75, 3.0, 0.0078125],
                         ids=['1', '0.75', '3', '2^-7'])
def test_kernel_quantize_static_matches_plain(inv):
    x = _adversarial(inv)
    inv_c = torch.full((16,), inv).to(torch.bfloat16)
    # per channel too: channel c scaled by a different bf16 value
    for iv in (inv_c, (inv_c.float() * torch.linspace(0.5, 2.0, 16)).to(
            torch.bfloat16)):
        want = quant.quant_act_static(x.permute(0, 3, 1, 2),
                                      iv.reshape(1, -1, 1, 1))
        got = _kernel_quant_static(x, iv)
        assert torch.equal(got, want.permute(0, 2, 3, 1))


@pytest.mark.parametrize('peak', [127.0, 254.0, 1.0, 3.3895e38],
                         ids=['127', '254', '1', 'max'])
def test_kernel_quantize_dynamic_matches_plain(peak):
    x = _adversarial(1.0)
    x[0, 0, 0, 0] = peak
    x[1] = 0.0                           # a sample of zeros: s = 1e-12
    want, s_want = quant.quant_act_dynamic(x.permute(0, 3, 1, 2))
    got, s = _kernel_quant_dynamic(x)
    assert torch.equal(s, s_want)
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    assert not got[1].any()
    # the max pass on its own, against the plain version
    assert torch.equal(C.sample_absmax_reference(x),
                       x.float().abs().amax(dim=(1, 2, 3)))


def _bf16_bits(a):
    """float32 numpy -> bf16 bit patterns (uint32), round to nearest even."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.uint32) & 0xffff


def _kernel_quant_dynamic_table(x):
    """The slab mode's dynamic quantize (csrc/conv_s8.cu qtab_base,
    qtab_entry, qtab_q) emulated in numpy on x (N, H, W, C) bf16: per
    sample a table of q at the 1280 magnitudes from bf16(s) / 4 up, each
    by the f32 division and the bf16 rounding; an element's magnitude
    bits minus the table's first, clamped to the end entries (0 below, 127
    above), its byte, the sign."""
    n = x.shape[0]
    w = x.view(torch.int16).numpy().astype(np.int64).reshape(n, -1) & 0xffff
    amax = x.float().abs().amax(dim=(1, 2, 3)).numpy()
    out = np.zeros(w.shape, np.int8)
    for i in range(n):
        s = np.maximum(np.float32(amax[i]) / np.float32(127.0),
                       np.float32(1e-12)).astype(np.float32)
        sbits = int(_bf16_bits(np.reshape(s, 1))[0])
        base = sbits - 256
        sb = np.array([sbits << 16], np.uint32).view(np.float32)
        mags = (np.arange(base, base + 1280, dtype=np.uint32) << 16).view(
            np.float32)
        with np.errstate(invalid='ignore'):   # past bf16's largest: NaN
            b = torch.from_numpy(mags / sb).to(torch.bfloat16).float().numpy()
        # fmin, as the kernel's fminf: a NaN gives 127
        tab = np.concatenate([[0], np.rint(np.fmin(b, 127)), [127]])
        idx = np.clip((w[i] & 0x7fff) - base + 1, 0, 1281)
        q = tab[idx].astype(np.int64)
        out[i] = np.where(w[i] & 0x8000, -q, q).astype(np.int8)
    return torch.from_numpy(out.reshape(x.shape))


@pytest.mark.parametrize('peaks', [(1.0, 127.0, 254.0, 3.3895e38),
                                   (1e-3, 5e-11, 0.0, 65504.0)],
                         ids=['large', 'small'])
def test_kernel_quantize_dynamic_table_matches_plain(peaks):
    """The slab mode's table of quantized values gives quant_act_dynamic's
    for every finite bf16 value at or below each sample's peak (every
    magnitude the sample can hold), bf16(s) from 1e-12 to the largest."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    finite = ((bits >> 7) & 0xff) != 0xff
    allv = torch.from_numpy(bits[finite].astype(np.uint16).view(
        np.int16)).view(torch.bfloat16)
    rows = []
    for peak in peaks:
        v = allv[allv.float().abs() <= peak]
        v = torch.cat([v, torch.full((1,), peak).to(torch.bfloat16)])
        rows.append(v)
    length = -(-max(len(r) for r in rows) // 8) * 8
    x = torch.zeros((len(peaks), length), dtype=torch.bfloat16)
    for i, r in enumerate(rows):
        x[i, :len(r)] = r
    x = x.reshape(len(peaks), 1, length // 8, 8)
    want, _ = quant.quant_act_dynamic(x.permute(0, 3, 1, 2))
    got = _kernel_quant_dynamic_table(x)
    assert torch.equal(got, want.permute(0, 2, 3, 1))


# -- the kernel's phases, taps and weight addressing, emulated ----------------

def _phases(kind, k, s, pad, op, h, w):
    """csrc/conv_s8.cu plan(): (stride, dil, ho, wo, [(nty, ntx, ky0, kx0,
    oy0, ox0, py, px, hp, wp)]) of a call as the wrappers pass it."""
    if kind == 'conv':
        stride, dil, ph, pw = s, 1, pad, pad
        ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
    else:
        stride, dil = 1, s
        lo, hi = k - 1 - pad, k - 1 - pad + op
        ph = pw = lo
        ho = (h - 1) * s + 1 + lo + hi - k + 1
        wo = (w - 1) * s + 1 + lo + hi - k + 1
    out = []
    for p in range(dil * dil):
        py, px = p // dil, p % dil
        ky0, kx0 = (ph - py) % dil, (pw - px) % dil
        nty, ntx = -(-(k - ky0) // dil), -(-(k - kx0) // dil)
        oy0 = (py + ky0 - ph) // dil     # exact: a multiple of dil
        ox0 = (px + kx0 - pw) // dil
        hp, wp = -(-(ho - py) // dil), -(-(wo - px) // dil)
        out.append((nty, ntx, ky0, kx0, oy0, ox0, py, px, hp, wp))
    return stride, dil, ho, wo, out


def _b_block(w_pk, kw, ky, kx, c, nb, bn):
    """The bytes of one step's bulk copy: (BN columns, 32 K bytes) int8, by
    the kernel's offset of (tap, step, block) and desc_kmajor's layout of
    column n, byte kb: (n / 8) 256 + (kb / 16) 128 + (n % 8) 16 + kb % 16."""
    nkc, cp = w_pk.shape[2], w_pk.shape[3] // 32
    flat = w_pk.reshape(-1)
    off = ((ky * kw + kx) * nkc + c) * cp * 32 + nb * bn * 32
    n = np.arange(bn)[:, None]
    kb = np.arange(32)[None, :]
    addr = off + (n // 8) * 256 + (kb // 16) * 128 + (n % 8) * 16 + kb % 16
    return flat[addr]


@pytest.mark.parametrize('cout', [24, 72, 256], ids=['n64', 'n128', 'n128x2'])
@pytest.mark.parametrize('name', list(KINDS))
def test_packed_weight_addressing(name, cout):
    """Every element of the packed image, read back where the kernel reads
    it, is w_q[ky, kx, ci, co] (zero past C_in and C_out), and every tap of
    w_q is read by exactly one phase."""
    kind, k, _, _, _ = KINDS[name]
    rng = np.random.default_rng(12)
    cin = 40
    w_q = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout)).astype(
        np.int8))
    w_pk = quant.pack_s8_weights(w_q).numpy()
    bn = quant.s8_block_n(cout)
    nkc, cp = w_pk.shape[2], w_pk.shape[3] // 32
    assert nkc == 2 and cp % bn == 0 and cp >= cout
    wq = np.zeros((k, k, nkc * 32, cp), np.int8)
    wq[:, :, :cin, :cout] = w_q.numpy()
    chan = quant.s8_column_channel(np.arange(bn), bn)
    assert sorted(chan) == list(range(bn))
    for ky in range(k):
        for kx in range(k):
            for c in range(nkc):
                for nb in range(cp // bn):
                    got = _b_block(w_pk, k, ky, kx, c, nb, bn)
                    want = wq[ky, kx][32 * c:32 * c + 32][:, nb * bn + chan].T
                    np.testing.assert_array_equal(got, want)
    _, s, pad, op = KINDS[name][1:]
    _, dil, _, _, phases = _phases(kind, k, s, pad, op, 7, 6)
    taps = sorted((ky0 + dil * ty, kx0 + dil * tx)
                  for nty, ntx, ky0, kx0, *_ in phases
                  for ty in range(nty) for tx in range(ntx))
    assert taps == sorted((a, b) for a in range(k) for b in range(k))


def _emulated_sums(x_q, w_pk, kind, k, s, pad, op):
    """The kernel's implicit GEMM in numpy: per phase, each output pixel's
    taps (input stride i + oy0 + ty, zero outside x), each 32-channel step
    through the packed image as _b_block reads it; int64 sums (N, HO, WO,
    C_out)."""
    n, h, w, cin = x_q.shape
    cout = w_pk.shape[3] // 32
    bn = quant.s8_block_n(cout)
    nkc = w_pk.shape[2]
    stride, dil, ho, wo, phases = _phases(kind, k, s, pad, op, h, w)
    chan = quant.s8_column_channel(np.arange(bn), bn)
    xp = np.zeros((n, h, w, nkc * 32), np.int64)
    xp[..., :cin] = x_q
    acc = np.zeros((n, ho, wo, cout), np.int64)
    for nty, ntx, ky0, kx0, oy0, ox0, py, px, hp, wp in phases:
        for i in range(hp):
            for j in range(wp):
                for ty in range(nty):
                    for tx in range(ntx):
                        iy, ix = stride * i + oy0 + ty, stride * j + ox0 + tx
                        if not (0 <= iy < h and 0 <= ix < w):
                            continue
                        ky, kx = ky0 + dil * ty, kx0 + dil * tx
                        for c in range(nkc):
                            a = xp[:, iy, ix, 32 * c:32 * c + 32]
                            for nb in range(cout // bn):
                                b = _b_block(w_pk, k, ky, kx, c, nb, bn)
                                acc[:, py + dil * i, px + dil * j,
                                    nb * bn + chan] += \
                                    a @ b.astype(np.int64).T
    return acc


@pytest.mark.parametrize('name', list(KINDS))
def test_emulated_implicit_gemm_matches_plain_conv(name):
    """The kernel's phases, taps, padding and weight addressing, emulated,
    give the plain int8 conv's int32 sums (C_in 40: a partial second step;
    C_out 24 in a 64-channel block)."""
    kind, k, s, pad, op = KINDS[name]
    rng = np.random.default_rng(13)
    x_q = rng.integers(-127, 128, (2, 7, 6, 40)).astype(np.int8)
    w_q = torch.from_numpy(rng.integers(-127, 128, (k, k, 40, 24)).astype(
        np.int8))
    got = _emulated_sums(x_q, quant.pack_s8_weights(w_q).numpy(), kind, k, s,
                         pad, op)
    ones = torch.ones(24)
    xt = torch.from_numpy(x_q)
    want = (C.conv2d_int8_reference(xt, w_q, ones, None, s, pad,
                                    torch.float32) if kind == 'conv' else
            C.conv_transpose2d_int8_reference(xt, w_q, ones, None, s, pad,
                                              op, torch.float32))
    np.testing.assert_array_equal(got[..., :24], want.numpy().astype(
        np.int64))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _to_cuda(qc):
    return quant.Int8Conv(*(None if t is None else t.cuda() for t in (
        qc.w, qc.w_q, qc.w_s, qc.w_pk, qc.a_s, qc.inv_a, qc.inv_c)))


# (name, x shape, C_out): the gather mode with C_in not a multiple of the
# 32-channel step, M not of the item's rows, C_out in each channel block,
# split K; the slab mode
CUDA_SHAPES = [('ragged', (3, 13, 11, 40), 24),
               ('n128', (2, 9, 17, 56), 72),
               ('n128x3_split', (2, 4, 5, 64), 264),
               # the slab mode: grids of 64-column multiples (a row per
               # m64 block), and narrower ones with enough items
               ('slab_wide', (2, 128, 128, 40), 72),
               ('slab_narrow', (32, 64, 62, 40), 24),
               # C_in 1024: the slab's chunks do not fit at once, a ring
               ('slab_ring', (2, 128, 128, 1024), 72)]


@pytest.mark.cuda
@pytest.mark.parametrize('scales', SCALES)
@pytest.mark.parametrize('shape', CUDA_SHAPES, ids=[c[0] for c in CUDA_SHAPES])
@pytest.mark.parametrize('name', list(KINDS))
def test_cuda_fused_bit_equal_to_plain(cuda, name, shape, scales):
    kind, k, s, pad, op = KINDS[name]
    _, xs, cout = shape
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(0, 2.0, xs).astype(np.float32)).to(
        torch.bfloat16).cuda()
    _, qc = _params(rng, kind, k, xs[3], cout, scales)
    qc = _to_cuda(qc)
    bias = torch.from_numpy(rng.normal(0, 1, cout).astype(np.float32)).to(
        torch.bfloat16).cuda()
    m0 = C.sample_absmax.launches
    y = _fused(x, qc, bias, kind, s, pad, op)
    assert C.sample_absmax.launches == m0 + (scales == 'dynamic')
    assert torch.equal(y, _fused(x, qc, bias, kind, s, pad, op,
                                 reference=True))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(16, 512, 512, 64), (3, 5, 7, 8),
                                   (2, 1, 1, 1024)],
                         ids=['down0', 'small', 'one_pixel'])
def test_cuda_max_pass(cuda, shape):
    """The max pass equals x.float().abs().amax per sample, bit for bit,
    a sample of zeros and a negative peak included."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        torch.bfloat16).cuda()
    x[0] = 0
    x[-1].view(-1)[-1] = -300.0
    got = C.sample_absmax(x)
    assert torch.equal(got, x.float().abs().amax(dim=(1, 2, 3)))
    assert got[0].item() == 0.0 and got[-1].item() == 300.0


@pytest.mark.cuda
def test_cuda_fused_refuses(cuda):
    """What the kernel does not take raises before any launch: a float32 or
    non-contiguous x, C_in % 8, C_in past 2048, the max pass on float32."""
    rng = np.random.default_rng(16)
    n0 = C.conv_s8.launches
    _, qc = _params(rng, 'conv', 3, 16, 8, 'static_channel')
    qc = _to_cuda(qc)
    x = torch.zeros((1, 6, 6, 16), dtype=torch.bfloat16, device='cuda')
    with pytest.raises(TypeError):
        C.conv2d_s8(x.float(), qc)
    with pytest.raises(TypeError):
        C.conv2d_s8(x.permute(0, 2, 1, 3), qc)
    _, q12 = _params(rng, 'conv', 3, 12, 8, 'dynamic')
    with pytest.raises(ValueError, match='C_in % 8'):
        C.conv2d_s8(torch.zeros((1, 6, 6, 12), dtype=torch.bfloat16,
                                device='cuda'), _to_cuda(q12))
    w_q = torch.zeros((1, 1, 2056, 8), dtype=torch.int8)
    big = quant.Int8Conv(None, w_q.cuda(), torch.ones(8, device='cuda'),
                         quant.pack_s8_weights(w_q).cuda())
    with pytest.raises(ValueError, match='2048'):
        C.conv2d_s8(torch.zeros((1, 2, 2, 2056), dtype=torch.bfloat16,
                                device='cuda'), big)
    with pytest.raises(ValueError, match='bf16'):
        C.sample_absmax(torch.zeros((2, 8), device='cuda'))
    assert C.conv_s8.launches == n0
