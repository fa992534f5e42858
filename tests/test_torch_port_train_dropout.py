"""One DeepLIIF train step with dropout, the port against the JAX package
on the CPU: dropout masks cannot match across the packages' random
generators, so both packages' ``layers.dropout`` are replaced inside the
test by one numpy mask per activation shape (keep p 0.5, kept values x 2).
The TINY model with unet_64 seg nets, whose depth-4 block drops out too
(unet_32 has no dropout block); the limits of
``test_torch_port_train_step.py`` (losses 1e-4 relative, gradients 1e-3
of max |g| per tensor, parameters after one step)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepliif_tpu.nets import layers as jL
from deepliif_tpu_torch.nets import layers as tL

from torch_train_helpers import (TINY, check_grads, check_losses,
                                 check_params_after_one_step, step_case)

_MASKS = {}
_CALLS = {'jax': 0, 'port': 0}


def _mask(nhwc):
    if nhwc not in _MASKS:
        seed = int(np.prod(nhwc)) % (2 ** 31)
        _MASKS[nhwc] = np.random.default_rng(seed).random(nhwc) < 0.5
    return _MASKS[nhwc]


def _jax_dropout(x, rng, rate=0.5, train=False):
    if not train or rng is None:
        return x
    _CALLS['jax'] += 1
    return jnp.where(_mask(tuple(x.shape)), x / (1.0 - rate),
                     jnp.zeros_like(x))


def _port_dropout(x, rng, rate=0.5, train=False):
    if not train:
        return x
    _CALLS['port'] += 1
    b, c, h, w = x.shape
    keep = torch.from_numpy(np.moveaxis(_mask((b, h, w, c)), -1, 1).copy())
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


@pytest.fixture(scope='module')
def run():
    mp = pytest.MonkeyPatch()
    mp.setattr(jL, 'dropout', _jax_dropout)
    mp.setattr(tL, 'dropout', _port_dropout)
    try:
        return step_case(dict(TINY, use_dropout=True,
                              net_gs=('unet_64',) * 3))
    finally:
        mp.undo()


def test_masks_reached_both_packages(run):
    # the translators' 6 resblocks and unet_64's one dropout block: traced
    # by JAX per call of the vmapped group, run per net by the port
    assert _CALLS['jax'] > 0 and _CALLS['port'] > 0
    assert {s[1:3] for s in _MASKS} >= {(16, 16), (4, 4)}


def test_losses_match_jax(run):
    check_losses(run, 0)


def test_gradients_match_jax(run):
    check_grads(run)


def test_parameters_after_one_step(run):
    check_params_after_one_step(run)
