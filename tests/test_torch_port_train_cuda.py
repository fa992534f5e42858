"""The port's training on the card (``cuda`` marker; skipped without a
CUDA device): the statistics Function (kernel forward, elementwise
backward) against autograd of the plain version, the train-mode norms'
launches, and one tiny DeepLIIF step on the card against the same step on
the CPU (loss terms 1e-4 relative, D gradients and G gradients 1e-3 of
max |g| per tensor, the G gradients without the perceptual term, whose L1
gradient is a step function of the rounding; see
tests/test_torch_port_train_step.py). Imports nothing of jax."""

import dataclasses

import numpy as np
import pytest
import torch

from deepliif_tpu_torch import models as M
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.nets import define_g, layers as L, vgg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    M.configure_device(torch.device('cuda'))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 256, 32, 32), (3, 24, 45, 37)])
@pytest.mark.parametrize('layout', ['channels_last', 'nchw'])
def test_cuda_statistics_function_matches_plain(cuda, shape, layout):
    g = torch.Generator(device='cuda').manual_seed(1)
    x = torch.randn(shape, generator=g, device='cuda') + 0.5
    if layout == 'channels_last':
        x = x.contiguous(memory_format=torch.channels_last)
    up = torch.randn(shape[0], 2, shape[1], generator=g, device='cuda')
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    before = L.plane_mean_var.launches
    st = L.plane_mean_var_train(xa)
    assert L.plane_mean_var.launches == before + 1
    ref = L.plane_mean_var_reference(xb)
    da, = torch.autograd.grad(st, xa, up)
    db, = torch.autograd.grad(ref, xb, up)
    for q in range(2):
        assert ((st[:, q] - ref[:, q]).abs().max()
                <= 1e-6 * ref[:, q].abs().max())
    assert (da - db).abs().max() <= 1e-5 * db.abs().max()


@pytest.mark.cuda
def test_cuda_train_forward_launches_a_statistics_kernel_per_norm(cuda):
    net = define_g(3, 3, 8, 'resnet_2blocks').cuda().train()
    x = torch.rand(2, 3, 32, 32, device='cuda')
    before = L.plane_mean_var.launches
    net(x, rng=torch.Generator('cuda').manual_seed(0)).sum().backward()
    # head, 2 down, 2 x 2 trunk, 2 up norms; none in the backward
    assert L.plane_mean_var.launches - before == 9


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
def test_cuda_one_tiny_step_matches_cpu(cuda):
    d = dl.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                       net_gs=('unet_32',) * 3, ngf=8, ndf=8,
                       seg_weights=(0.4, 0.3, 0.3),
                       loss_g_weights=(1 / 3,) * 3,
                       loss_d_weights=(1 / 3,) * 3, use_dropout=False)
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    rng = np.random.default_rng(0)
    arrays = {'A': rng.uniform(-1, 1, (2, 64, 64, 3)),
              'B_mods': rng.uniform(-1, 1, (2, 2, 64, 64, 3)),
              'B_seg': rng.uniform(-1, 1, (2, 64, 64, 3))}
    res = {}
    for dev in ('cuda', 'cpu'):
        batch = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                 for k, v in arrays.items()}
        vnet = vgg.VGG19Features().to(dev)
        state = dl.create_train_state(d, opt, 1, 0, dev)
        loss, _ = dl.g_loss_fn(state.nets, batch,
                               dataclasses.replace(d, lambda_feat=0.0), vnet)
        g_grads = [g.cpu() for g in torch.autograd.grad(loss,
                                                        state.g_params)]
        _, metrics, _ = dl.make_train_step(d, vnet)(state, batch)
        res[dev] = ({k: v.cpu() for k, v in metrics.items()}, g_grads,
                    [p.grad.cpu() for p in state.d_params])
    (mc, gc, dc), (mp, gp, dp) = res['cuda'], res['cpu']
    for k in mp:
        assert _rel(mc[k], mp[k]) <= 1e-4, k
    for a, b in zip(gc + dc, gp + dp):
        assert _rel(a, b) <= 1e-3
