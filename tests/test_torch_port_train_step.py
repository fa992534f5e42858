"""One and two DeepLIIF train steps of the port against the JAX package's
jitted step on the CPU, at the JAX test's TINY model (modalities 2,
resnet_6blocks, unet_32, ngf = ndf = 8, 64^2, batch 2, no dropout), the
same weights (drawn by the port, carried into JAX trees), VGG and
batches (``torch_train_helpers.step_case``).

Limits: every loss term within 1e-4 relative; D and G gradients per
tensor within 1e-3 of the tensor's max |g| against ``jax.value_and_grad``
of ``d_loss_fn`` / ``g_loss_fn`` at the same parameters (G against the
updated discriminators, JAX's); after one step the parameters within 1e-6
on at least 99.9 % of all elements and within 2 lr everywhere (Adam's
first update is lr sign(g), and a gradient element near 0 may take either
sign in the two packages). Step 2 starts in both packages from JAX's
state after step 1, read by the port from the JAX package's checkpoint
files (the optimizer held apart from the gradients).

The perceptual term is an L1 of VGG features, so its gradient w.r.t. the
generators' outputs is a step function of sign(a - b): a float32 rounding
difference of the outputs (~1e-6) flips it at a few feature positions and
moves single gradient elements by percent. So the G gradients are held
with that upstream gradient taken from JAX's forward (the port's nets
then backpropagate it and every other term themselves), and the upstream
gradient is held on its own at identical inputs, in float64 in both
packages (with the default VGG19, JAX's own draw, float32 flips deep
feature positions at these inputs in either package). The JAX step is
compiled once for the file."""

import numpy as np
import pytest

from torch_train_helpers import (LR, TINY, check_grads, check_losses,
                                 check_params_after_one_step, step_case)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    return step_case(dict(TINY, use_dropout=False),
                     str(tmp_path_factory.mktemp('jax_step1')))


@pytest.mark.parametrize('step', [0, 1])
def test_losses_match_jax(run, step):
    check_losses(run, step)


def test_gradients_match_jax(run):
    check_grads(run)


def test_parameters_after_one_step(run):
    check_params_after_one_step(run)


def test_second_step_from_the_shared_state(run):
    """Step 2 from JAX's state after step 1 (loaded from the JAX package's
    files: parameters, Adam moments, counts equal; its losses are held by
    ``test_losses_match_jax[1]``): parameters within 2.12 lr everywhere
    (at update 2, with b1 0.5 and b2 0.999, |mu^ / sqrt(nu^)| <= 1.055).
    Update 2 follows the gradients' magnitudes, and the perceptual term's
    step-function gradient moves single elements by percent, so no
    per-element 1e-6 share is held here."""
    equal, step, count = run['shared_after_1']
    assert equal and step == 1 and count == 1
    diffs = np.concatenate([np.abs(run['port'][1][part][k]
                                   - run['jax'][1][part][k]).ravel()
                            for part in ('g', 'd')
                            for k in run['jax'][1][part]])
    assert diffs.max() <= 2.12 * LR
