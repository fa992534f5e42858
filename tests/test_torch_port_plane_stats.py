"""The port's norm statistics (nets/layers.py ``plane_mean_var`` and
``plane_sums``, the one-read kernel csrc/plane_stats.cu) against the JAX
package's per-sample norm statistics and against float64.

- CPU: ``plane_mean_var_reference`` against the JAX package's two-pass
  formula (deepliif_tpu/nets/layers.py batch_stat_norm, per_sample=True:
  the mean, then the mean of (x - mean)^2, in float32) and the whole norm
  against ``batch_stat_norm`` of the JAX package, on numpy inputs from a
  seed, float32 and bfloat16. Tolerances as in
  tests/test_torch_port_fused_stages.py: statistics within 1e-6 relative,
  outputs within 1e-5 (float32) or one bf16 ulp (bfloat16: scale and bias
  round to bf16, so a statistic one float32 ulp apart can move a value by
  one ulp).
- CPU: a numpy emulation of the kernel's arithmetic (its chunks from
  ``layers._plane_geometry``: per-thread float32 sums, the fixed tree over
  the pixel lanes (NHWC) or the warp butterfly and the warps in order
  (NCHW), the chunk mean, the chunk's sum of (x - mean)^2, then Chan's
  merge over ``layers._PLANE_SEG`` runs in chunk order) against float64,
  at ragged P
  (not a multiple of the chunk) and a large offset (mean 100, std 1):
  mean and variance within 1e-6 relative, where sum x^2 - n mean^2 in
  float32 is off by more than 1e-3 on the same inputs.
- ``cuda``: the kernel against its plain version at ragged P, C in {24,
  64, 512}, 2x2 planes and the large offset, in channels_last and in NCHW
  memory (both read in place), within 1e-5 relative (chip_smoke.py
  PLANE_TOL: float32 sums of the same values in other orders), byte-equal
  run to run and alone vs in the batch; an input in neither layout is
  copied and counted in ``relayouts``; ``plane_sums`` (the fused head's
  sums, derived from one ``plane_mean_var`` call) against plain sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepliif_tpu.nets import layers as L_jax
from deepliif_tpu_torch.nets import layers as L

BF16_ULP = 2.0 ** -7
PLANE_TOL = 1e-5            # chip_smoke.py PLANE_TOL
F32 = np.float32


def _cast(a, dtype):
    """numpy float32 NHWC -> (torch NCHW view in channels_last memory, jax
    NHWC array) holding the same values in ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return t.permute(0, 3, 1, 2), j


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_two_pass(xj):
    """The JAX package's per-sample statistics (layers.py batch_stat_norm,
    per_sample=True), (S, 2, C): the float32 mean over H, W, then the mean
    of (x - mean)^2."""
    x32 = xj.astype(jnp.float32)
    mean = x32.mean(axis=(1, 2), keepdims=True)
    var = ((x32 - mean) ** 2).mean(axis=(1, 2), keepdims=True)
    return np.stack([_np(mean[:, 0, 0]), _np(var[:, 0, 0])], axis=1)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(3, 40, 48, 24), (2, 2, 2, 512)],
                         ids=['40x48x24', '2x2x512'])
def test_plane_mean_var_reference_matches_jax(shape, dtype):
    rng = np.random.default_rng(11)
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    xt, xj = _cast(x, dtype)
    got = L.plane_mean_var_reference(xt).numpy()
    ref = _jax_two_pass(xj)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(L.plane_mean_var(xt), L.plane_mean_var_reference(xt))

    c = shape[3]
    scale = (1 + 0.1 * rng.normal(0, 1, c)).astype(np.float32)
    bias = (0.1 * rng.normal(0, 1, c)).astype(np.float32)
    out = _np(L.batch_stat_norm(xt, torch.from_numpy(scale),
                                torch.from_numpy(bias)).permute(0, 2, 3, 1))
    want = _np(L_jax.batch_stat_norm(xj, {'scale': jnp.asarray(scale),
                                          'bias': jnp.asarray(bias)},
                                     per_sample=True))
    if dtype == 'float32':
        assert np.abs(out - want).max() <= 1e-5
    else:
        assert (np.abs(out - want) <= BF16_ULP * np.abs(want) + 1e-6).all()


# ---- the kernel's arithmetic in numpy float32

def _tree(v, rows):
    """csrc/plane_stats.cu lane_sum: lane pl adds lane pl + h, h halving
    from the power of two below rows."""
    v = v.copy()
    h = 1
    while 2 * h < rows:
        h *= 2
    while h >= 1:
        k = min(h, rows - h)
        if k > 0:
            v[:k] = (v[:k] + v[h:h + k]).astype(F32)
        h //= 2
    return v[0]


def _chan(state, nb, mb, m2b):
    """csrc/plane_stats.cu chan_merge in float32."""
    n, mean, m2 = state
    if nb == 0:
        return state
    nn = F32(n + nb)
    d = (mb - mean).astype(F32)
    mean = (mean + d * F32(nb / nn)).astype(F32)
    m2 = (m2 + (m2b + (d * d).astype(F32) * F32(F32(n * nb) / nn))
          .astype(F32)).astype(F32)
    return nn, mean, m2


def _butterfly_then_warps(v):
    """csrc/plane_stats.cu block_sum over 256 threads' values: an xor
    butterfly in each warp of 32, then the 8 warps' sums in order."""
    w = v.reshape(8, 32).copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = (w + w[:, lanes ^ o]).astype(F32)
    total = w[0, 0]
    for k in range(1, 8):
        total = F32(total + w[k, 0])
    return total


def _chunk_nhwc(seg, rows, loads):
    """One chunk's (n, mean, M2) per channel as the NHWC kernel takes them:
    thread (pl, unit) holds pixels pl + rows i, the lanes meet in a tree."""
    n, c = seg.shape
    held = np.zeros((loads * rows, c), F32)
    held[:n] = seg
    held = held.reshape(loads, rows, c)         # [i, pl]: pixel pl + rows i
    s = held[0].copy()
    for i in range(1, loads):
        s = (s + held[i]).astype(F32)
    mean = (_tree(s, rows) / F32(n)).astype(F32)
    valid = (np.arange(loads * rows) < n).reshape(loads, rows, 1)
    d = np.where(valid, held - mean, F32(0)).astype(F32)
    q = (d[0] * d[0]).astype(F32)
    for i in range(1, loads):
        q = (q + (d[i] * d[i]).astype(F32)).astype(F32)
    return F32(n), mean, _tree(q, rows)


def _chunk_nchw(seg, chunk, loads):
    """One chunk of one plane as the NCHW kernel takes it: thread t holds
    loads t + 256 i of per_load values each, then block_sum."""
    n = len(seg)
    per_load = chunk // (256 * loads)
    held = np.zeros(chunk, F32)
    held[:n] = seg
    held = held.reshape(loads, 256, per_load)    # [i, t, k]
    valid = (np.arange(chunk) < n).reshape(loads, 256, per_load)
    acc = np.zeros(256, F32)
    for i in range(loads):
        for k in range(per_load):
            acc = (acc + held[i, :, k]).astype(F32)
    mean = F32(_butterfly_then_warps(acc) / F32(n))
    q = np.zeros(256, F32)
    for i in range(loads):
        for k in range(per_load):
            d = np.where(valid[i, :, k], held[i, :, k] - mean, F32(0))
            q = (q + (d * d).astype(F32)).astype(F32)
    return F32(n), mean, _butterfly_then_warps(q)


def emulate_plane_mean_var(x, elem, nchw=False):
    """One sample's (P, C) float32 values -> (mean, var) as the kernel
    takes them, for elements of ``elem`` bytes in NHWC or NCHW memory."""
    p, c = x.shape
    _, rows, chunk, n_chunks = L._plane_geometry(p, c, elem, nchw)
    loads = L._PLANE_LOADS
    parts = []
    for j in range(n_chunks):
        seg = x[j * chunk:(j + 1) * chunk]
        if nchw:
            one = [_chunk_nchw(seg[:, ch], chunk, loads) for ch in range(c)]
            parts.append((one[0][0], np.array([o[1] for o in one], F32),
                          np.array([o[2] for o in one], F32)))
        else:
            parts.append(_chunk_nhwc(seg, rows, loads))
    seg = L._PLANE_SEG
    length = -(-n_chunks // seg)
    runs = []
    for r in range(seg):
        state = (F32(0), np.zeros(c, F32), np.zeros(c, F32))
        for j in range(r * length, min((r + 1) * length, n_chunks)):
            state = _chan(state, *parts[j])
        runs.append(state)
    state = runs[0]
    for run in runs[1:]:
        state = _chan(state, *run)
    return state[1], (state[2] / F32(p)).astype(F32)


@pytest.mark.parametrize('p,c,elem,nchw', [
    (37 * 29 * 11, 24, 4, False), (1000, 64, 2, False),
    (9 * 1021, 8, 4, False), (150 * 131, 3, 4, True),
    (37 * 29 * 11, 2, 2, True)],
    ids=['nhwc-f32-ragged-24', 'nhwc-bf16-one-chunk-64',
         'nhwc-f32-ragged-8', 'nchw-f32-ragged', 'nchw-bf16-unaligned'])
def test_chunk_then_merge_against_float64_at_large_offset(p, c, elem, nchw):
    _, _, chunk, n_chunks = L._plane_geometry(p, c, elem, nchw)
    assert p % chunk != 0 or n_chunks == 1
    rng = np.random.default_rng(12)
    x = rng.normal(100.0, 1.0, (p, c)).astype(F32)
    mean, var = emulate_plane_mean_var(x, elem, nchw)
    x64 = x.astype(np.float64)
    mean64 = x64.mean(axis=0)
    var64 = ((x64 - mean64) ** 2).mean(axis=0)
    assert np.abs(mean / mean64 - 1).max() < 1e-6
    assert np.abs(var / var64 - 1).max() < 1e-6
    # the one-pass formula loses the digits on the same inputs
    naive = ((x * x).sum(axis=0, dtype=F32) / F32(p)
             - (x.sum(axis=0, dtype=F32) / F32(p)) ** 2)
    assert np.abs(naive / var64 - 1).max() > 1e-3


def test_geometry_depends_on_the_plane_only():
    # the flagship head norm (512^2 x 64 bf16): 32 pixel lanes x 8 units,
    # 512-pixel chunks
    assert L._plane_geometry(512 * 512, 64, 2) == (8, 32, 512, 512)
    for p, c, elem in ((4, 512, 2), (16, 512, 2), (64, 512, 4),
                       (262144, 64, 4), (1, 8, 2)):
        g, rows, chunk, n_chunks = L._plane_geometry(p, c, elem)
        units = c // (16 // elem)
        assert 1 <= g <= 32 and g * rows <= 256
        assert chunk == rows * L._PLANE_LOADS and n_chunks == -(-p // chunk)
        # the unet_512's innermost planes still give a sample 16 blocks
        assert g == 1 or -(-units // g) * n_chunks >= 16
    # NCHW: 256 threads x 16 loads of 16 bytes of a plane, or of one value
    # where a plane is not a multiple of 16 bytes (it may start unaligned)
    assert L._plane_geometry(256 * 256, 64, 4, True) == (0, 0, 16384, 4)
    assert L._plane_geometry(4, 512, 4, True) == (0, 0, 16384, 1)
    assert L._plane_geometry(35, 64, 2, True) == (0, 0, 4096, 1)


# ---- the kernel on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _card_input(shape, dtype, mean=0.3, seed=13):
    """(S, C, H, W) on the card in channels_last memory, from numpy."""
    rng = np.random.default_rng(seed)
    s, c, h, w = shape
    x = rng.normal(mean, 1.0, (s, h, w, c)).astype(np.float32)
    return torch.from_numpy(x).cuda().to(dtype).permute(0, 3, 1, 2)


def _rel(got, ref):
    return max(((got[:, q] - ref[:, q]).abs().max()
                / ref[:, q].abs().max()).item() for q in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['nhwc', 'nchw'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', [(3, 24, 37, 29), (2, 64, 45, 51),
                                   (4, 512, 2, 2), (2, 512, 33, 17),
                                   (2, 64, 512, 512)],
                         ids=['ragged-24', 'ragged-64', '2x2-512',
                              'ragged-512', 'flagship-64'])
def test_cuda_plane_stats_kernel_matches_plain_version(cuda, shape, dtype,
                                                       layout):
    x = _card_input(shape, dtype)
    if layout == 'nchw':
        x = x.contiguous()
    launches, relayouts = L.plane_mean_var.launches, L.plane_mean_var.relayouts
    got = L.plane_mean_var(x)
    sums = L.plane_sums(x)
    assert L.plane_mean_var.launches == launches + 2
    assert L.plane_mean_var.relayouts == relayouts
    assert _rel(got, L.plane_mean_var_reference(x)) < PLANE_TOL
    d = x.float()
    plain_sums = torch.stack([d.sum(dim=(2, 3)), (d * d).sum(dim=(2, 3))],
                             dim=1)
    assert _rel(sums, plain_sums) < PLANE_TOL
    assert torch.equal(got, L.plane_mean_var(x))
    alone = L.plane_mean_var(x[1:2])
    assert torch.equal(alone[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_cuda_plane_stats_kernel_at_large_offset(cuda, dtype):
    x = _card_input((2, 64, 61, 47), dtype, mean=100.0)
    got = L.plane_mean_var(x)
    ref = L.plane_mean_var_reference(x)
    assert _rel(got, ref) < PLANE_TOL
    # the variance itself, not only its share of the mean's scale
    rel_var = ((got[:, 1] - ref[:, 1]).abs() / ref[:, 1]).max().item()
    assert rel_var < PLANE_TOL


@pytest.mark.cuda
def test_cuda_plane_stats_counts_a_copy_for_other_layouts(cuda):
    x = _card_input((2, 64, 20, 24), torch.bfloat16)
    n = L.plane_mean_var.relayouts
    got = L.plane_mean_var(x)                     # channels_last: in place
    L.plane_mean_var(x.contiguous())              # NCHW: in place
    assert L.plane_mean_var.relayouts == n
    odd = x.transpose(2, 3)                       # neither: copied first
    assert not odd.is_contiguous() and not odd.is_contiguous(
        memory_format=torch.channels_last)
    mv = L.plane_mean_var(odd)
    assert L.plane_mean_var.relayouts == n + 1
    assert _rel(mv, got) < PLANE_TOL
    # NCHW planes of any C; channels_last needs C % 8 at bfloat16
    c12 = _card_input((2, 12, 5, 7), torch.bfloat16)
    assert _rel(L.plane_mean_var(c12.contiguous()),
                L.plane_mean_var_reference(c12)) < PLANE_TOL
    with pytest.raises(ValueError, match='C % 8'):
        L.plane_mean_var(c12)
