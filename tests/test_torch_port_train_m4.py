"""One DeepLIIF train step at modalities 4 with the default seg, G-loss
and D-loss weights ((0.25, 0.15, 0.25, 0.1, 0.25), 0.2 each), the port
against the JAX package on the CPU: the TINY nets otherwise (resnet_6blocks,
unet_32, ngf = ndf = 8, 64^2, batch 2, no dropout), and the limits of
``test_torch_port_train_step.py``."""

import pytest

from torch_train_helpers import (TINY, check_grads, check_losses,
                                 check_params_after_one_step, step_case)

M4 = {k: v for k, v in TINY.items()
      if k not in ('seg_weights', 'loss_g_weights', 'loss_d_weights')}
M4.update(modalities_no=4, net_g=('resnet_6blocks',) * 4,
          net_gs=('unet_32',) * 5, use_dropout=False)


@pytest.fixture(scope='module')
def run():
    return step_case(M4)


def test_losses_match_jax(run):
    check_losses(run, 0)


def test_gradients_match_jax(run):
    check_grads(run)


def test_parameters_after_one_step(run):
    check_params_after_one_step(run)
