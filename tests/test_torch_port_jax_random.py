"""The port's numpy threefry (``utils.jax_random``) against ``jax.random``
on the CPU, and the default VGG19 of the perceptual loss (no weights npz)
against the JAX package's default draw. Key splits, random bits and
uniforms are bit-equal; normals within 3 float32 ulps (numpy's ``log``
against XLA's CPU approximation of it), and the VGG19 kernels (those
normals times the kaiming std) within 4; the perceptual loss of one pair
within 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu.nets import vgg as jv
from deepliif_tpu_torch.nets import vgg as tv
from deepliif_tpu_torch.utils import jax_random as R

NORMAL_ULPS, VGG_ULPS = 3, 4


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_threefry_partitionable_is_on():
    # the numpy draw follows JAX's partitionable threefry (JAX >= 0.5)
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize('seed', [0, 19, 12345, 2 ** 31 - 1])
def test_keys_and_splits_bit_equal(seed):
    key, ref = R.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(ref))
    for num in (2, 3, 2, 5):
        got, want = R.split(key, num), np.asarray(jax.random.split(ref, num))
        np.testing.assert_array_equal(got, want)
        key, ref = got[-1], jnp.asarray(want[-1])


@pytest.mark.parametrize('shape', [(7,), (3, 3, 5, 11), (2, 1, 257)])
def test_bits_and_uniform_bit_equal(shape):
    key = R.split(R.PRNGKey(7))[1]
    ref = jnp.asarray(key)
    np.testing.assert_array_equal(
        R.random_bits(key, shape),
        np.asarray(jax.random.bits(ref, shape, jnp.uint32)))
    np.testing.assert_array_equal(R.uniform(key, shape),
                                  np.asarray(jax.random.uniform(ref, shape)))
    np.testing.assert_array_equal(
        R.uniform(key, shape, -2.0, 3.0),
        np.asarray(jax.random.uniform(ref, shape, minval=-2.0, maxval=3.0)))


def test_normal_within_ulps():
    key = R.split(R.PRNGKey(19))[1]
    shape = (3, 3, 64, 128)
    got = R.normal(key, shape)
    want = np.asarray(jax.random.normal(jnp.asarray(key), shape))
    d = _ulps(got, want)
    assert got.dtype == np.float32 and got.shape == shape
    assert d.max() <= NORMAL_ULPS, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()


def test_default_vgg19_is_the_jax_default(monkeypatch):
    monkeypatch.delenv('DEEPLIIF_VGG19_WEIGHTS', raising=False)
    params = jv.init()
    net = tv.VGG19Features()
    flat = [c for sp in params for c in sp]
    assert len(flat) == len(net.convs) == 13
    equal = total = 0
    for conv, p in zip(net.convs, flat):
        hwio = conv.weight.detach().permute(2, 3, 1, 0).numpy()
        d = _ulps(hwio, p['w'])
        assert d.max() <= VGG_ULPS, (conv.weight.shape, d.max())
        equal, total = equal + (d == 0).sum(), total + d.size
        assert not conv.bias.any() and not np.asarray(p['b']).any()
    assert equal / total >= 0.99, equal / total

    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    got = tv.vgg_loss(net, nchw(x), nchw(y)).item()
    want = float(jv.vgg_loss(params, jnp.asarray(x), jnp.asarray(y)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
