"""The port's collectives and kernels over several devices, without jax.

- The train-mode batch norm under data parallelism
  (``parallel.gather_rows``, autograd-aware): two spawned gloo ranks, each
  on its rows of a global batch, against ``layers.train_batch_norm`` of
  the global batch in one process: the outputs, the gradients w.r.t. x
  (each rank its rows) and w.r.t. the scale and bias (summed over ranks)
  within 1e-6 of the largest value (the two sum in another order). On the
  CPU, and on the card (``cuda`` marker: both ranks on cuda:0, where the
  statistics come from the ``plane_stats`` kernel).
- ``conv_s8`` launched on cuda:1 after cuda:0 (two cards; skipped
  otherwise): bit-equal to its plain version on each card. Its dynamic
  shared memory attribute belongs to the device it is set on.
"""

import numpy as np
import pytest
import torch

import torch_dp_worker as W
from deepliif_tpu_torch import models as M
from deepliif_tpu_torch.ops import conv_int8 as C, quant


def _check_norm(ranks, device):
    x, up, scale, bias = W.norm_case(device)
    y, (dx, dscale, dbias) = W.norm_grads(x, up, scale, bias)
    got = {'y': torch.cat([r['y'] for r in ranks]),
           'dx': torch.cat([r['dx'] for r in ranks]),
           'dscale': ranks[0]['dscale'], 'dbias': ranks[0]['dbias']}
    for k, want in (('y', y), ('dx', dx), ('dscale', dscale),
                    ('dbias', dbias)):
        want = want.cpu()
        assert (got[k] - want).abs().max() <= 1e-6 * want.abs().max(), k
    for k in ('dscale', 'dbias'):
        assert torch.equal(ranks[0][k], ranks[1][k]), k


def test_data_parallel_batch_norm_matches_one_process(tmp_path):
    _check_norm(W.spawn_norm_ranks(['cpu', 'cpu'], str(tmp_path)), 'cpu')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    M.configure_device(torch.device('cuda'))


@pytest.mark.cuda
def test_cuda_data_parallel_batch_norm_matches_one_process(cuda, tmp_path):
    _check_norm(W.spawn_norm_ranks(['cuda:0', 'cuda:0'], str(tmp_path)),
                'cuda:0')


@pytest.mark.cuda
@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
def test_cuda_conv_s8_on_a_second_card(cuda, static):
    """The slab mode (its dynamic shared memory above 48 KB) on cuda:0,
    then on cuda:1, each bit-equal to the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices')
    rng = np.random.default_rng(4)
    cin, cout = 64, 128
    x = torch.from_numpy(rng.normal(0, 1.5, (2, 64, 64, cin)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(
        np.float32))
    qc = quant.quantize_conv(w, w.permute(2, 3, 1, 0).contiguous(),
                             4.0 if static else None, torch.bfloat16)
    for dev in ('cuda:0', 'cuda:1'):
        q = quant.Int8Conv(*(None if t is None else t.to(dev) for t in (
            qc.w, qc.w_q, qc.w_s, qc.w_pk, qc.a_s, qc.inv_a, qc.inv_c)))
        xd = x.to(dev)
        n0 = C.conv_s8.launches
        y = C.conv2d_s8(xd, q, None, 2, 1)
        torch.cuda.synchronize(dev)
        assert C.conv_s8.launches == n0 + 1 and y.device == xd.device
        assert torch.equal(y, C.conv2d_s8_reference(xd, q, None, 2, 1)), dev
