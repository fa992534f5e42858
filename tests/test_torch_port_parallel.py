"""Tile inference over several devices in the port
(``deepliif_tpu_torch.parallel``, ``InferenceSession`` with ``devices=`` /
``n_devices``), on the CPU.

- ``models._bucket`` equals the JAX session's ``_bucket`` over a grid of
  (tiles, max_batch, device count).
- A session of two replicas (``devices=('cpu', 'cpu')``: each bucket cut
  into two contiguous shards, one host thread each) gives outputs
  byte-equal to the one-replica session's: 13 tiles (the bucket padded to
  a multiple of the replicas; one empty tile), seg-only, the intermediates,
  the device-kept GS, bfloat16, int8 and the fused stages; and within the uint8
  tolerance of ``test_torch_port_inference.py`` (1 LSB on fewer than 0.1 %
  of pixels) of the JAX session on its 8 virtual devices, on the TINY
  config of ``tests/test_parallel.py``.
- Clamps and refusals: ``DEEPLIIF_INFER_DEVICES`` above the device count
  clamps, ``n_devices`` takes the first of ``devices``, a ``max_batch``
  that does not split raises ValueError, ``DEEPLIIF_QUANT_MESH=1`` with
  two replicas and ``spatial_halo_apply`` raise NotImplementedError naming
  "Serving".
- The kernels' launch counters count every increment when many threads
  count at once (``cuda_build.count``).
- ``parallel``'s shard helpers.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from deepliif_tpu import models as M_jax
from deepliif_tpu_torch import models as M, parallel
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.ops import cuda_build

# the TINY config of tests/test_parallel.py:16 (its mesh-session test's
# config.json)
CFG = {'model': 'DeepLIIF', 'modalities_no': 2, 'seg_gen': True,
       'seg_no': 1, 'input_no': 1, 'netG': 'resnet_6blocks',
       'net_gs': 'unet_32', 'ngf': 8, 'ndf': 8, 'norm': 'batch',
       'no_dropout': False, 'padding': 'zero', 'upsample': 'convtranspose',
       'scale_size': 64, 'seg_weights': [0.4, 0.3, 0.3],
       'modalities_names': ['IHC', 'ModA', 'Marker'],
       'background_colors': [(201, 211, 208), (10, 10, 10)]}
TWO = ('cpu', 'cpu')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(md, ngf=8):
    d = dl.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                       net_gs=('unet_32',) * 3, ngf=ngf,
                       seg_weights=(0.4, 0.3, 0.3))
    smoke.write_model_dir(md, dl.DeepLIIFNets(d), dict(CFG, ngf=ngf), seed=3)
    return md


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp('parallel_tiny')))


@pytest.fixture(scope='module')
def tiles():
    t = np.random.default_rng(11).integers(0, 255, (13, 64, 64, 3), np.uint8)
    t[6] = 120                          # an empty tile: background-filled
    return t


def _host(out):
    if isinstance(out, tuple):
        host, dev = out
        return {**host, **{k: v.cpu().numpy() for k, v in dev.items()}}
    return out


@pytest.mark.parametrize('max_batch,multiple', [
    (16, 1), (32, 2), (64, 4), (12, 4), (36, 2), (3, 4), (128, 8)])
def test_bucket_matches_jax(max_batch, multiple):
    for n in range(1, 41):
        assert M._bucket(n, max_batch, multiple) == M_jax._bucket(
            n, max_batch, multiple), n


@pytest.fixture(scope='module')
def sessions(model_dir):
    return {'one': M.InferenceSession(model_dir, device='cpu'),
            'two': M.InferenceSession(model_dir, devices=TWO)}


CASES = {'full': {}, 'seg_only': {'seg_only': True},
         'intermediate': {'return_intermediate': True},
         'device_keys': {'device_keys': ('GS',)}}


@pytest.mark.parametrize('case', sorted(CASES))
def test_two_replicas_byte_equal_one(sessions, tiles, case):
    one, two = sessions['one'], sessions['two']
    assert (two.n_devices, two.max_batch, two.card_batch) == (2, 32, 16)
    assert two.replicas[0] is two.nets and two.replicas[1] is not two.nets
    forwards = []
    run = two.forward

    def counted(x, **kw):
        forwards.append((int(x.shape[0]), kw['replica']))
        return run(x, **kw)
    two.forward = counted
    try:
        got = _host(two.run_tiles(tiles, **CASES[case]))
    finally:
        del two.forward
    # 12 non-empty tiles in a bucket of 16: two shards of 8, one each
    assert sorted(forwards) == [(8, 0), (8, 1)]
    want = _host(one.run_tiles(tiles, **CASES[case]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == 'device_keys':
        dev = two.run_tiles(tiles, device_keys=('GS',))[1]['GS']
        assert dev.device == two.device


def _assert_u8_close(a, b):
    """The uint8 tolerance of tests/test_torch_port_inference.py."""
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert a.shape == b.shape and diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_two_replicas_within_tolerance_of_jax_mesh(model_dir, sessions,
                                                   tiles):
    jax_mesh = M_jax.InferenceSession(model_dir)   # the suite's 8 devices
    assert jax_mesh.n_devices == 8 and jax_mesh.mesh is not None
    want = jax_mesh.run_tiles(tiles)
    got = sessions['two'].run_tiles(tiles)
    assert set(got) == set(want) == {'G1', 'G2', 'GS'}
    for k in want:
        _assert_u8_close(got[k], want[k])


@pytest.mark.parametrize('precision', ['bfloat16', 'int8', 'fused'])
def test_two_replicas_byte_equal_at_low_precision(tmp_path, tiles,
                                                  precision):
    """int8 at ngf 16 (no conv quantizes below 16 channels): both sessions
    calibrate on the same first tiles (the model dir's act_scales.json is
    written by the first and read by the second); the fused translator
    stages (bfloat16) at ngf 32 (their gate wants a trunk of C % 128)."""
    md = _write(str(tmp_path), ngf={'int8': 16, 'fused': 32}.get(precision,
                                                                  8))
    kw = dict(precision=precision, int8_calibrate=precision == 'int8')
    if precision == 'fused':
        kw = dict(precision='bfloat16', fuse_stages=True)
    want = M.InferenceSession(md, device='cpu', **kw).run_tiles(tiles[:5])
    two = M.InferenceSession(md, devices=TWO, **kw)
    got = two.run_tiles(tiles[:5])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_counts_clamp(model_dir, monkeypatch):
    monkeypatch.setenv('DEEPLIIF_INFER_DEVICES', '5')
    s = M.InferenceSession(model_dir, device='cpu')
    assert (s.n_devices, s.max_batch) == (1, M.DEFAULT_MAX_BATCH)
    s = M.InferenceSession(model_dir, devices=TWO, n_devices=5)
    assert s.n_devices == 2 and s.devices == [torch.device('cpu')] * 2
    s = M.InferenceSession(model_dir, devices=TWO, n_devices=1)
    assert s.n_devices == 1 and len(s.replicas) == 1
    assert parallel.get_devices('cpu', n=0) == [torch.device('cpu')]
    with pytest.raises(ValueError, match='split'):
        M.InferenceSession(model_dir, devices=TWO, max_batch=5)


def test_mesh_sharded_labeling_raises(model_dir, monkeypatch):
    monkeypatch.setenv('DEEPLIIF_QUANT_MESH', '1')
    M.InferenceSession(model_dir, device='cpu')      # one device: no mesh
    with pytest.raises(NotImplementedError, match=r'ROADMAP\.md, "Serving"'):
        M.InferenceSession(model_dir, devices=TWO)
    with pytest.raises(NotImplementedError, match=r'ROADMAP\.md, "Serving"'):
        parallel.spatial_halo_apply(lambda x: x, torch.zeros(4, 4, 1),
                                    halo=1)


def test_launch_counter_counts_every_thread():
    """16 threads x 2000 counts, with a short switch interval: no update
    is lost."""
    def fn():
        pass
    fn.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            cuda_build.count(fn) for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fn.launches == 16 * 2000


def test_shard_helpers():
    assert parallel.shard_bounds(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError):
        parallel.shard_bounds(6, 4)
    assert parallel.pad_to_multiple(13, 4) == 16
    batch = {'A': np.arange(4), 'B_mods': np.arange(8).reshape(2, 4),
             'A_paths': ['a', 'b', 'c', 'd']}
    sh = parallel.shard_batch(batch, 1, 2)
    np.testing.assert_array_equal(sh['A'], [2, 3])
    np.testing.assert_array_equal(sh['B_mods'], [[2, 3], [6, 7]])
    assert sh['A_paths'] == ['c', 'd']
    assert parallel.torchrun_env({}) is None
    env = dict(RANK='3', WORLD_SIZE='4', LOCAL_RANK='1', LOCAL_WORLD_SIZE='2',
               MASTER_ADDR='localhost', MASTER_PORT='1')
    assert parallel.torchrun_env(env) == (3, 4, 1, 2)
    dp = parallel.DataParallel(3, 4, 1, 2)
    assert (dp.node, dp.nodes) == (1, 2)
    with parallel.data_parallel(parallel.DataParallel(0, 1)):
        assert parallel.current() is None     # a world of one: one device
