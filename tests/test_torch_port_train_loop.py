"""The port's training loop end to end on the CPU, against the JAX
package where the two meet: ``train`` through the CLI (checkpoints, logs,
image grids, background colors, --debug, --save-by-iter), --continue-train
(step and parameters restored), --with-val (losses and the cell-count
RMSE), the loader's batches equal to the JAX ``create_dataset``'s for one
seed, the nets' ``latest_net_*.npz`` read by the JAX ``load_networks``,
``{epoch}_optim.npz`` crossing both ways, the CLI's options those of the
JAX ``train`` plus ``--device``, and what raises NotImplementedError
("Training"): bfloat16, spectral norm, the attention U-Net and orbax
checkpoints in any family, and several cards."""

import json
import os
import random
import types

import click
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deepliif_tpu import cli as jcli, nets as jnets
from deepliif_tpu.config import Options as JOptions
from deepliif_tpu.config import TRAIN_DEFAULTS as J_DEFAULTS
from deepliif_tpu.data import create_dataset as j_create_dataset
from deepliif_tpu.utils import background as jbg, checkpoints as jck
from deepliif_tpu_torch import cli, roadmap, train_loop
from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
from deepliif_tpu_torch.data import create_dataset
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.utils import checkpoints as ck

from torch_train_helpers import jax_params

SIZE = 64
ARGS = ['--modalities-no', '2', '--net-g', 'resnet_2blocks', '--net-gs',
        'unet_32', '--ngf', '8', '--ndf', '8', '--load-size', str(SIZE),
        '--crop-size', str(SIZE), '--scale-size', str(SIZE), '--seed', '0',
        '--device', 'cpu']


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(d, count=4, m=2, seed=0):
    """Rows A | B1..Bm | B_seg of SIZE tiles; the seg tile black with a few
    red and blue blobs (empty 32 px tiles for the background colors)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(count):
        tiles = [rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)
                 for _ in range(m + 1)]
        seg = np.zeros((SIZE, SIZE, 3), np.uint8)
        seg[4:12, 4:12] = (255, 0, 0)
        seg[40:48, 8:16] = (0, 0, 255)
        Image.fromarray(np.concatenate(tiles + [seg], axis=1)).save(
            os.path.join(d, f'r{i}.png'))


def _train(tmp_path, *extra, name='run'):
    cli.make_cli().main(['train', '--dataroot', str(tmp_path / 'data'),
                         '--checkpoints-dir', str(tmp_path / 'ckpt'),
                         '--name', name] + ARGS + list(extra),
                        standalone_mode=False)
    return tmp_path / 'ckpt' / name


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """One CLI run: 2 epochs of 2 steps (batch 2), prints, a display,
    epoch saves."""
    root = tmp_path_factory.mktemp('train')
    _rows(str(root / 'data' / 'train'))
    out = _train(root, '--batch-size', '2', '--n-epochs', '1',
                 '--n-epochs-decay', '1', '--print-freq', '2',
                 '--display-freq', '4', '--save-epoch-freq', '1')
    return root, out


def test_cli_train_writes_checkpoints_logs_and_grids(trained):
    root, out = trained
    files = set(os.listdir(out))
    for ep in ('latest', '1', '2'):
        assert {f'{ep}_net_{g}.npz' for g in ('G', 'GS', 'D', 'DS')} | {
            f'{ep}_optim.npz'} <= files, files
    assert {'train_opt.txt', 'config.json', 'loss_log.txt',
            'metrics_log.json', 'loss_plot.png'} <= files
    log = (out / 'loss_log.txt').read_text()
    assert log.count('loss_G:') == 4 and 'D_real_S:' in log
    assert any(f.endswith('fake_B_S.png') for f in os.listdir(
        out / 'web' / 'images'))
    cfg = json.loads((out / 'config.json').read_text())
    assert cfg['model'] == 'DeepLIIF' and cfg['device'] == 'cpu'
    # background colors from the train dir's empty seg tiles, as in JAX
    want = jbg.infer_background_colors(str(root / 'data' / 'train'),
                                       modalities_no=2, return_list=True)
    assert cfg['background_colors'] == [list(c) for c in want]
    with np.load(out / 'latest_optim.npz') as data:
        assert int(data['step']) == 4 and int(data['g/0/.count']) == 4


def test_checkpoint_serves_in_the_port_and_loads_in_jax(trained):
    """latest_net_*.npz: the port's InferenceSession runs it, and the JAX
    ``load_networks`` reads every group with the nets' values."""
    from deepliif_tpu_torch import models as M
    _, out = trained
    tiles = np.random.default_rng(1).integers(0, 255, (1, SIZE, SIZE, 3),
                                              np.uint8)
    res = M.InferenceSession(str(out), device='cpu').run_tiles(tiles)
    assert sorted(res) == ['G1', 'G2', 'GS']
    d = dl.def_from_opt(Options(d_params={**TRAIN_DEFAULTS, 'modalities_no':
                                          2, 'netG': 'resnet_2blocks',
                                          'net_gs': 'unet_32', 'ngf': 8,
                                          'ndf': 8}, mode='train'))
    nets_ = dl.init_nets(d, torch.Generator().manual_seed(9))
    like = jax_params(nets_, ('G', 'GS', 'D', 'DS'))
    loaded = jck.load_networks(str(out), like)
    ck.load_networks(str(out), nets_)
    for name, tree in jax_params(nets_, ('G', 'GS', 'D', 'DS')).items():
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(loaded[name])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_continue_train_restores_step_and_parameters(trained, tmp_path):
    root, out = trained
    saved = {g: dict(np.load(out / f'latest_net_{g}.npz'))
             for g in ('G', 'D')}
    load = ck.load_networks
    seen = {}

    def spy(save_dir, nets_, epoch='latest'):
        load(save_dir, nets_, epoch)
        seen['G'] = ck.group_flat(nets_.G)
        seen['D'] = ck.group_flat(nets_.D)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, 'load_networks', spy)
        state, _ = cli.run_train(dict(
            dataroot=str(root / 'data'), checkpoints_dir=str(root / 'ckpt'),
            name='run', modalities_no=2, net_g='resnet_2blocks',
            net_gs='unet_32', ngf=8, ndf=8, load_size=SIZE, crop_size=SIZE,
            scale_size=SIZE, seed=0, device='cpu', batch_size=2, n_epochs=1,
            n_epochs_decay=0, continue_train=True, epoch='latest',
            print_freq=100), echo=lambda *_: None)
    assert state.step == 4 + 2 and state.g_opt.count == 6
    for g in ('G', 'D'):
        assert sorted(seen[g]) == sorted(saved[g])
        for k in saved[g]:
            np.testing.assert_array_equal(seen[g][k], saved[g][k])
    with pytest.raises(FileNotFoundError, match='continue-train'):
        cli.run_train(dict(dataroot=str(root / 'data'),
                           checkpoints_dir=str(tmp_path), name='none',
                           modalities_no=2, net_g='resnet_2blocks',
                           net_gs='unet_32', ngf=8, ndf=8, load_size=SIZE,
                           crop_size=SIZE, scale_size=SIZE, device='cpu',
                           continue_train=True), echo=lambda *_: None)


@pytest.mark.parametrize('policy', ['linear', 'plateau'])
@pytest.mark.parametrize('name', ['adam', 'adamw', 'rmsprop', 'adagrad',
                                  'sgd'])
def test_optim_npz_crosses_into_jax_and_back(tmp_path, name, policy):
    """The port's ``_optim.npz`` after two updates: the JAX package's
    ``load_pytree`` reads it into its optax state (every key and shape of
    its layout) with the port's counts and moments; the JAX package's own
    file of that state loads back into the port with the same values."""
    d = dl.DeepLIIFDef(modalities_no=1, net_g=('resnet_2blocks',),
                       net_gs=('unet_32',) * 2, ngf=8, ndf=8,
                       seg_weights=(0.5, 0.5), loss_g_weights=(0.5, 0.5),
                       loss_d_weights=(0.5, 0.5))
    opt = types.SimpleNamespace(optimizer=name, lr_policy=policy,
                                n_epochs=1, n_epochs_decay=1, epoch_count=1,
                                beta1=0.5, lr_g=2e-4, lr_d=2e-4)
    state = dl.create_train_state(d, opt, 1, 0)
    for i in range(2):
        for p in state.g_params + state.d_params:
            p.grad = torch.randn(p.shape, generator=torch.Generator()
                                 .manual_seed(i))
        state.g_opt.step()
        state.d_opt.step()
    state.step = 2
    if policy == 'plateau':
        for group in state.g_opt.param_groups:
            group['lr'] = 4e-5
    path = str(tmp_path / 'latest_optim.npz')
    ck.save_optim(path, state, policy == 'plateau')
    gp, dp = (jax_params(state.nets, n) for n in (('G', 'GS'), ('D', 'DS')))
    tx = jnets.make_optimizer(opt, 2e-4, 1)
    like = {'g': tx.init(gp), 'd': tx.init(dp), 'step': jnp.zeros((),
                                                                  jnp.int32)}
    loaded = jck.load_pytree(path, like)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(ck.flatten_tree(
            jax.tree_util.tree_map(np.asarray, _tree_dict(like))))
    assert int(loaded['step']) == 2
    jpath = str(tmp_path / 'jax_optim.npz')
    jck.save_pytree(jpath, loaded)
    fresh = dl.create_train_state(d, opt, 1, 1)
    ck.load_optim(jpath, fresh, policy == 'plateau')
    assert fresh.step == 2 and fresh.g_opt.count == fresh.d_opt.count == 2
    for a, b in ((state.g_opt, fresh.g_opt), (state.d_opt, fresh.d_opt)):
        assert a.param_groups[0]['lr'] == pytest.approx(
            b.param_groups[0]['lr'])
        for p, q in zip(a.param_groups[0]['params'],
                        b.param_groups[0]['params']):
            for k, v in a.state[p].items():
                torch.testing.assert_close(b.state[q][k], v, rtol=0, atol=0)


def _tree_dict(tree):
    """An optax state as nested dicts keyed like the JAX checkpoint's
    flattening."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = '/'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                       for k in path)
        node = out
        *parents, last = key.split('/')
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def test_loader_batches_equal_jax_for_one_seed(tmp_path):
    _rows(str(tmp_path / 'data' / 'train'), count=5, seed=3)
    params = {**J_DEFAULTS, 'dataroot': str(tmp_path / 'data'),
              'modalities_no': 2, 'load_size': 72, 'crop_size': SIZE,
              'batch_size': 2, 'seed': 7, 'num_threads': 1}
    ours = create_dataset(Options(d_params=dict(params), mode='train'))
    theirs = j_create_dataset(JOptions(d_params=dict(params), mode='train'))
    assert len(ours) == len(theirs) == 5
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        random.seed(epoch)              # the crops and flips' global state
        a = list(ours)
        random.seed(epoch)
        b = list(theirs)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert x['A_paths'] == y['A_paths']
            for k in ('A', 'B_mods', 'B_seg'):
                np.testing.assert_array_equal(x[k], y[k])


def test_with_val_writes_losses_and_cell_count_rmse(tmp_path):
    _rows(str(tmp_path / 'data' / 'train'), count=2)
    _rows(str(tmp_path / 'data' / 'val'), count=2, seed=5)
    with open(tmp_path / 'data' / 'val' / 'metrics.json', 'w') as f:
        json.dump({f'r{i}': {'num_total': 3, 'num_pos': 1, 'num_neg': 2,
                             'percent_pos': 33.3} for i in range(2)}, f)
    out = _train(tmp_path, '--with-val', '--n-epochs', '1',
                 '--n-epochs-decay', '0', '--debug', '--debug-data-size',
                 '1')
    hist = json.loads((out / 'metrics_log.json').read_text())
    assert hist['val'] and 'loss_G' in hist['val'][0]['losses']
    assert hist['metrics'] and 'rmse_num_total' in hist['metrics'][0][
        'metrics']
    assert (out / 'latest_net_DS.npz').exists()


def test_save_by_iter_and_load_iter(tmp_path):
    _rows(str(tmp_path / 'data' / 'train'), count=2)
    out = _train(tmp_path, '--save-by-iter', '--save-latest-freq', '1',
                 '--n-epochs', '1', '--n-epochs-decay', '0')
    assert {'iter_1_net_G.npz', 'iter_2_optim.npz'} <= set(os.listdir(out))
    opt = cli.train_options({'dataroot': str(tmp_path / 'data'),
                             'load_iter': 2}, echo=lambda *_: None)
    assert opt.epoch == 'iter_2' and opt.continue_train


def test_cli_train_options_are_jax_train_options_plus_device():
    jtrain = jcli.cli.commands['train']
    ttrain = cli.make_cli().commands['train']
    jopts = {p.name: p.default for p in jtrain.params}
    topts = {p.name: p.default for p in ttrain.params}
    assert set(topts) == set(jopts) | {'device'}
    assert {k: topts[k] for k in jopts} == jopts
    assert topts['device'] == 'cuda'
    jflags = {tuple(p.opts) for p in jtrain.params}
    assert jflags <= {tuple(p.opts) for p in ttrain.params}
    # the weights, names and dataset mode as the JAX command builds them
    kw = {'dataroot': '/nonexistent', 'lr': 1e-3, 'n_layers_d': 3,
          'modalities_names': 'a, b', 'modalities_no': 2, 'model':
          'DeepLIIF'}
    opt = cli.train_options(kw, echo=lambda *_: None)
    assert (opt.lr_g, opt.lr_d, opt.n_layers_D) == (1e-3, 1e-3, 3)
    assert opt.loss_G_weights == [1 / 3] * 3
    assert opt.modalities_names == ['a', 'b'] and opt.netG == opt.net_g
    assert opt.dataset_mode == 'aligned' and opt.device == 'cuda'


def test_train_device_and_gpu_ids():
    assert cli.train_device(None, None) == 'cuda'
    assert cli.train_device('cuda', '1') == 'cuda:1'
    assert cli.train_device('cpu', '') == 'cpu'
    with pytest.raises(NotImplementedError, match='"Training"'):
        cli.train_device('cuda', '0,1')
    for device, ids in (('cuda', '-1'), ('cuda', 'a'), ('cpu', '0')):
        with pytest.raises(ValueError):
            cli.train_device(device, ids)


@pytest.mark.parametrize('extra', [
    ['--model', 'CycleGAN', '--norm', 'spectral'],
    ['--model', 'DeepLIIFExt', '--precision', 'bfloat16'],
    ['--precision', 'bfloat16'], ['--norm', 'spectral'],
    ['--checkpoint-format', 'orbax'], ['--gpu-ids', '0,1'],
    ['--net-gs', 'unet_512_attention']])
def test_what_training_does_not_run_raises(tmp_path, extra):
    _rows(str(tmp_path / 'data' / 'train'), count=1)
    with pytest.raises(NotImplementedError, match=r'ROADMAP\.md, "Training"'):
        _train(tmp_path, *extra)


@pytest.mark.parametrize('command', ['trainlaunch', 'eval',
                                     'prepare-training-data',
                                     'prepare-testing-data', 'register',
                                     'visualize', 'compute-statistics'])
def test_commands_not_ported_raise(command):
    """The commands still to port raise NotImplementedError naming their
    ROADMAP item; the host commands ported since are real click commands
    (an unknown option is a usage error)."""
    import click
    if command not in cli._NOT_PORTED_COMMANDS:
        with pytest.raises(click.NoSuchOption):
            cli.make_cli().main([command, '--anything', 'x'],
                                standalone_mode=False)
        return
    item = roadmap.STATS if command == 'compute-statistics' \
        else roadmap.TRAINING
    with pytest.raises(NotImplementedError, match=f'"{item}"'):
        cli.make_cli().main([command, '--anything', 'x'],
                            standalone_mode=False)


def test_train_on_a_cuda_device_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    _rows(str(tmp_path / 'data' / 'train'), count=1)
    with pytest.raises((RuntimeError, AssertionError)):
        cli.make_cli().main(['train', '--dataroot', str(tmp_path / 'data'),
                             '--checkpoints-dir', str(tmp_path / 'c')] +
                            ARGS[:-2], standalone_mode=False)


def test_check_weights_and_plateau_training(tmp_path):
    with pytest.raises(ValueError):
        train_loop.check_weights('DeepLIIF', 2, [0.5, 0.5], [1 / 3] * 3,
                                 [1 / 3] * 3)
    _rows(str(tmp_path / 'data' / 'train'), count=2)
    state, metrics = cli.run_train(dict(
        dataroot=str(tmp_path / 'data'), checkpoints_dir=str(tmp_path / 'c'),
        name='p', modalities_no=2, net_g='resnet_2blocks', net_gs='unet_32',
        ngf=8, ndf=8, load_size=SIZE, crop_size=SIZE, scale_size=SIZE,
        device='cpu', lr_policy='plateau', optimizer='rmsprop', n_epochs=1,
        n_epochs_decay=0), echo=lambda *_: None)
    assert state.step == 2 and state.g_opt.kind == 'rmsprop'
    assert np.isfinite(float(metrics['loss_G']))
    with np.load(tmp_path / 'c' / 'p' / 'latest_optim.npz') as data:
        assert '.hyperparams/learning_rate' in ''.join(data.files)


TRANSFERRED = []


def record_transfer(path):
    """A --remote-transfer-cmd target: records each saved file's name."""
    TRANSFERRED.append(os.path.basename(path))


def test_epoch_count_and_remote_transfer(tmp_path):
    """--epoch-count starts the epoch numbering (and the schedule) there;
    --remote-transfer-cmd gets every file of each save."""
    _rows(str(tmp_path / 'data' / 'train'), count=2)
    TRANSFERRED.clear()
    out = _train(tmp_path, '--epoch-count', '3', '--n-epochs', '3',
                 '--n-epochs-decay', '0', '--save-epoch-freq', '1',
                 '--remote-transfer-cmd',
                 'test_torch_port_train_loop.record_transfer')
    assert {'3_net_G.npz', '3_optim.npz'} <= set(os.listdir(out))
    assert not any(f.startswith(('1_', '2_')) for f in os.listdir(out))
    assert {'3_net_DS.npz', '3_optim.npz', 'latest_net_G.npz',
            'latest_optim.npz'} <= set(TRANSFERRED)
