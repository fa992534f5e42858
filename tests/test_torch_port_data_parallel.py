"""Data-parallel training in the port (``deepliif_tpu_torch.parallel``,
``train_loop``, ``cli trainlaunch``) on the CPU, with gloo ranks.

- One DeepLIIF step (the JAX test's TINY model, batch norm, dropout on) in
  two spawned ranks on a global batch of 4, each rank on its contiguous
  shard of 2: the losses (global means) within LOSS_RTOL relative of the
  port's one-process step on the global batch; each gradient tensor
  within GRAD_RTOL of the largest |g| of its net (the two sum the batch in
  another order, and a gradient that is 0 up to rounding, such as a bias
  before a batch norm, is held against its net's scale); the parameters
  after the step within 1e-6 wherever |g| is above its tolerance and
  within 2 lr everywhere (Adam's first update is lr sign(g)); the
  parameters bitwise equal across the ranks. The one-process step is held
  against JAX's in tests/test_torch_port_train_*.py.
- The same step without dropout (the packages' dropout masks cannot be
  shared under data parallelism) against JAX's
  ``make_data_parallel_train_step`` on a 2-device mesh with the same
  weights and batch: the losses and the updated ``head_conv`` weights
  within tests/test_parallel.py's own tolerances (one JAX step compile).
- Two CycleGAN steps (pool size 2, so the pools swap images from the
  first step) in two ranks against the one-process steps: the pools are
  queried with the global batch's fakes on every rank; losses and the
  first step's gradients as above, the parameters after two steps within
  4 lr, bitwise equal across ranks.
- The loader: for 1 and 2 nodes of 2 local ranks, each step's rank slices
  concatenated are the JAX loader's host batch of that node (its rows, in
  order, and their pixels), disjoint across ranks.
- ``trainlaunch`` in two processes with a torchrun environment (gloo, one
  epoch on 4 rows): both join the group, the run is data parallel, the
  losses finite, and the checkpoint loads in the JAX package.
- A global batch that does not divide by the device count trains on the
  first device in this process, and a line says why.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dp_worker as W
import torch_train_helpers as H
from conftest import cpu_subprocess_env
from deepliif_tpu import parallel as jparallel
from deepliif_tpu.config import Options as JOptions
from deepliif_tpu.data import create_dataset as jax_create_dataset
from deepliif_tpu.models import deepliif as jdl
from deepliif_tpu.utils import checkpoints as jck
from deepliif_tpu_torch import parallel
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.data import create_dataset
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.nets import vgg as vgg_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ('deepliif', 'deepliif_no_dropout', 'cyclegan')
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
LR = 2e-4


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Each case in two spawned ranks and, while they run, in this
    process."""
    tmp = tmp_path_factory.mktemp('dp')
    vgg_path = W.write_vgg(str(tmp / 'vgg.npz'))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks, one = W.spawn_ranks(2, CASES, vgg_path, str(tmp), lambda: {
            case: W.run_case(case, vgg_path) for case in CASES})
    finally:
        torch.set_num_threads(n)
    return {'ranks': ranks, 'one': one, 'vgg_path': vgg_path}


def _net_scale(grads):
    """{tensor: the largest |g| of its net ('G.0', 'DS.2', ...)}."""
    scale = {}
    for k, g in grads.items():
        net = '.'.join(k.split('.')[:2])
        scale[net] = max(scale.get(net, 0.0), float(np.abs(g).max()))
    return {k: scale['.'.join(k.split('.')[:2])] for k in grads}


def _check_losses(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def _check_step(got, want):
    """One step from the same state: losses, gradients, parameters."""
    _check_losses(got['metrics'], want['metrics'])
    scale = _net_scale(want['grads'])
    assert sorted(got['grads']) == sorted(want['grads'])
    for k, g in want['grads'].items():
        tol = GRAD_RTOL * scale[k]
        assert np.abs(got['grads'][k] - g).max() <= tol, k
        diff = np.abs(got['params'][k] - want['params'][k])
        assert diff[np.abs(g) > tol].max(initial=0) <= 1e-6, k
        assert diff.max() <= 2 * LR * (1 + 1e-3), k


def _ranks_equal(ranks, case):
    for s0, s1 in zip(ranks[0][case]['steps'], ranks[1][case]['steps']):
        for k, v in s0['params'].items():
            assert np.array_equal(v, s1['params'][k]), k
        for k, v in s0['metrics'].items():
            assert np.array_equal(v, s1['metrics'][k]), k


@pytest.mark.parametrize('case', ['deepliif', 'deepliif_no_dropout'])
def test_deepliif_step_matches_one_process(runs, case):
    _ranks_equal(runs['ranks'], case)
    _check_step(runs['ranks'][0][case]['steps'][0],
                runs['one'][case]['steps'][0])


def test_cyclegan_steps_match_one_process(runs):
    _ranks_equal(runs['ranks'], 'cyclegan')
    got, want = (runs['ranks'][0]['cyclegan']['steps'],
                 runs['one']['cyclegan']['steps'])
    _check_step(got[0], want[0])
    _check_losses(got[1]['metrics'], want[1]['metrics'])
    for k, v in want[1]['params'].items():
        assert np.abs(got[1]['params'][k] - v).max() <= 4 * LR * (1 + 1e-3), k


def test_deepliif_step_matches_jax_mesh(runs):
    """tests/test_parallel.py's tolerances: losses within 2e-3 relative;
    the head conv's update: median |diff| below 1e-6, max within 2 lr +
    1e-6, fewer than 5 % of elements above 1e-5."""
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    d = dl.DeepLIIFDef(**W.TINY, use_dropout=False)
    state = dl.create_train_state(d, opt, 1, 0)
    jstate, g_tx, d_tx = H.jax_state(state, opt)
    vp = H.vgg_jax(vgg_t.VGG19Features(runs['vgg_path']))
    mesh = jparallel.get_mesh(2)
    step = jparallel.make_data_parallel_train_step(
        jdl.make_train_step_body(jdl.DeepLIIFDef(**W.TINY, use_dropout=False),
                                 g_tx, d_tx, vp), mesh)
    batch = {k: jnp.asarray(v) for k, v in W.batch_arrays(1).items()}
    jstate, jm, _ = step(jstate, batch, jax.random.PRNGKey(0))
    got = runs['ranks'][0]['deepliif_no_dropout']['steps'][0]
    for k in ('loss_G', 'loss_D'):
        np.testing.assert_allclose(float(got['metrics'][k]), float(jm[k]),
                                   rtol=2e-3)
    state.nets.load_state_dict({k: torch.from_numpy(v) for k, v in
                                got['params'].items()}, strict=False)
    w1 = H.flat(H.jax_params(state.nets, ('G',)))['G/head_conv/w']
    w2 = np.asarray(jstate.g_params['G']['head_conv']['w'])
    diff = np.abs(w1 - w2)
    assert np.median(diff) < 1e-6
    assert diff.max() <= 2 * 2e-4 + 1e-6
    assert float((diff > 1e-5).mean()) < 0.05


def _data_opts(root, **kw):
    p = dict(TRAIN_DEFAULTS, dataroot=str(root), modalities_no=2,
             batch_size=4, load_size=32, crop_size=32, no_flip=True,
             seed=3, num_threads=1, **kw)
    return Options(d_params=dict(p)), JOptions(d_params=dict(p))


@pytest.mark.parametrize('nodes', [1, 2])
def test_loader_slices_make_the_jax_host_batch(tmp_path, nodes):
    H.write_rows(str(tmp_path / 'train'), 4, count=13, size=32)
    for node in range(nodes):
        opt, jopt = _data_opts(tmp_path, rank=node, world_size=nodes)
        jax_ds = jax_create_dataset(jopt, phase='train')
        ports = [create_dataset(opt, phase='train', local_rank=r,
                                local_world=2) for r in range(2)]
        for ds in (jax_ds, *ports):
            ds.set_epoch(2)
        steps = list(zip(jax_ds, *ports))
        assert len(steps) == -(-len(range(node, 13, nodes)) // 4)
        for want, *parts in steps:
            assert [len(p['A_paths']) for p in parts] == [2, 2]
            assert sum((p['A_paths'] for p in parts), []) == \
                want['A_paths']
            for k in ('A', 'B_seg'):
                np.testing.assert_array_equal(
                    np.concatenate([p[k] for p in parts]), want[k])
            np.testing.assert_array_equal(
                np.concatenate([p['B_mods'] for p in parts], axis=1),
                want['B_mods'])
        seen = [sum((list(step[1 + r]['A_paths']) for step in steps
                     [:-1]), []) for r in range(2)]
        assert not set(seen[0]) & set(seen[1])


THIRDS = ','.join([repr(1 / 3)] * 3)


def test_trainlaunch_two_processes(tmp_path):
    H.write_rows(str(tmp_path / 'data' / 'train'), 4, count=4)
    vgg_path = W.write_vgg(str(tmp_path / 'vgg.npz'))
    port = parallel.free_port()
    args = [sys.executable, '-m', 'deepliif_tpu_torch.cli', 'trainlaunch',
            '--dataroot', str(tmp_path / 'data'), '--name', 'dp',
            '--checkpoints-dir', str(tmp_path / 'ckpt'), '--modalities-no',
            '2', '--net-g', 'resnet_6blocks', '--net-gs', 'unet_32', '--ngf',
            '8', '--ndf', '8', '--load-size', '64', '--crop-size', '64',
            '--scale-size', '64', '--batch-size', '2', '--n-epochs', '1',
            '--n-epochs-decay', '0', '--print-freq', '2', '--seed', '0',
            '--seg-weights', '0.4,0.3,0.3', '--loss-weights-g', THIRDS,
            '--loss-weights-d', THIRDS, '--num-threads', '1', '--device',
            'cpu']
    procs = []
    for rank in range(2):
        env = cpu_subprocess_env(
            RANK=str(rank), WORLD_SIZE='2', LOCAL_RANK=str(rank),
            LOCAL_WORLD_SIZE='2', MASTER_ADDR='localhost',
            MASTER_PORT=str(port), OMP_NUM_THREADS='1',
            DEEPLIIF_VGG19_WEIGHTS=vgg_path)
        procs.append(subprocess.Popen(args, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    for rank, (out, _) in enumerate(outs):
        assert f'process group: rank {rank} of 2' in out
    assert 'data-parallel over 2 cards' in outs[0][0]
    run = tmp_path / 'ckpt' / 'dp'
    log = (run / 'loss_log.txt').read_text()
    losses = [float(v) for v in re.findall(r'loss_G: ([-\d.e]+)', log)]
    assert losses and np.isfinite(losses).all()
    with np.load(run / 'latest_optim.npz') as f:
        assert int(f['step']) == 2      # 4 rows, a global batch of 2
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    state = dl.create_train_state(dl.DeepLIIFDef(**W.TINY), opt, 1, 0)
    like = {**H.jax_params(state.nets, ('G', 'GS')),
            **H.jax_params(state.nets, ('D', 'DS'))}
    loaded = jck.load_networks(str(run), like)
    assert set(loaded) == {'G', 'GS', 'D', 'DS'}
    assert all(np.isfinite(np.asarray(v)).all()
               for v in jax.tree_util.tree_leaves(loaded))


def test_batch_that_does_not_divide_trains_on_one_device(tmp_path):
    """The JAX loop's use_mesh rule: a global batch of 1 on two devices
    trains in this process on the first, and a line says why."""
    from deepliif_tpu_torch import cli, train_loop
    H.write_rows(str(tmp_path / 'data' / 'train'), 4, count=1)
    with cli.make_cli().commands['train'].make_context('train', [
            '--dataroot', str(tmp_path / 'data'), '--checkpoints-dir',
            str(tmp_path / 'ckpt'), '--modalities-no', '2']
            + H.CLI_ARGS) as ctx:
        opt = cli.train_options(ctx.params, echo=lambda *_: None)
    said = []
    state, metrics = train_loop.train_on_devices(opt, ['cpu', 'cpu'],
                                                 echo=said.append)
    assert state.step == 1 and np.isfinite(float(metrics['loss_G']))
    assert said == ['the global batch (1) does not divide by the card count '
                    '(2): training on cpu alone']
