"""The port's batch pipeline and power-of-two buckets
(``InferenceSession.run_tiles``, ``batch_size``, ``probe_bucket``) on
tiny model dirs (ngf 8, 64^2 tiles, ``max_batch`` 8), on the CPU.

37 tiles with every fourth one empty run in batches 8, 8, 8 and a bucket
of 4: each output is held to the JAX engine's ``run_tiles`` on the same
dir (within 1 LSB on fewer than 0.1 % of pixels: the truncating float32
-> uint8 cast flips where the two frameworks' sums straddle an integer)
and byte-equal to the same tiles run one at a time, on the full forward,
seg-only, the seg intermediates, the device-kept GS and DeepLIIFExt. A
counting wrapper around ``forward`` shows at most two batches in flight
and batch i+1 launched before batch i is collected. The bucket rule's
probe runs here by adding the CPU to the probed devices: every bucket
holds on the CPU (each conv runs on one sample), and a bucket whose
outputs are made to differ is refused and skipped for the next one; the
bucket's hook pads a cuDNN call whose bits would differ."""

import numpy as np
import pytest
import torch

from deepliif_tpu import models as M_jax
from deepliif_tpu.models import deepliif as dl_jax
from deepliif_tpu.models import deepliif_ext as ext_jax
from deepliif_tpu_torch import models as M
from deepliif_tpu_torch.serve.dispatch import DispatchSession
from test_inference import TINY_CFG
from test_torch_port_families import _ext_cfg, _init, _write

N_TILES, MAX_BATCH = 37, 8


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('pipeline')
    d = dl_jax.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                           net_gs=('unet_32',) * 3, ngf=8, ndf=8,
                           seg_weights=(0.4, 0.3, 0.3))
    cfg = dict(TINY_CFG, modalities_names=['IHC', 'ModA', 'Marker'])
    ext = ext_jax.DeepLIIFExtDef(
        modalities_no=2, net_g=('resnet_6blocks',) * 2,
        net_gs=('unet_32',) * 2, ngf=8, ndf=8, loss_g_weights=(0.5, 0.5),
        loss_d_weights=(0.5, 0.5))
    return {'deepliif': _write(str(root / 'deepliif'),
                               _init(dl_jax.init_params, d, 7), cfg),
            'ext': _write(str(root / 'ext'),
                          _init(ext_jax.init_params, ext, 3), _ext_cfg())}


def _tiles(seed=11):
    tiles = np.random.default_rng(seed).integers(
        0, 255, (N_TILES, 64, 64, 3), np.uint8)
    tiles[::4] = 120                    # empty: skipped, background-filled
    return tiles


CASES = {'full': ('deepliif', {}),
         'seg_only': ('deepliif', {'seg_only': True}),
         'intermediate': ('deepliif', {'return_intermediate': True}),
         'device_keys': ('deepliif', {'device_keys': ('GS',)}),
         'ext': ('ext', {})}


def _host(out):
    """run_tiles' result as one dict of numpy arrays."""
    if isinstance(out, tuple):
        host, dev = out
        return {**host, **{k: np.asarray(v.cpu() if hasattr(v, 'cpu')
                                         else v) for k, v in dev.items()}}
    return out


def _assert_u8_close(a, b):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert a.shape == b.shape and diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


@pytest.fixture(scope='module')
def sessions(dirs):
    return {name: M.InferenceSession(md, device='cpu', max_batch=MAX_BATCH)
            for name, md in dirs.items()}


@pytest.mark.parametrize('case', sorted(CASES))
def test_run_tiles_matches_jax_and_tile_by_tile(dirs, sessions, case):
    family, kw = CASES[case]
    session, tiles = sessions[family], _tiles()
    got = _host(session.run_tiles(tiles, **kw))
    ref = _host(M_jax.InferenceSession(dirs[family], n_devices=1,
                                       max_batch=MAX_BATCH).run_tiles(
        tiles, **kw))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.uint8
        _assert_u8_close(got[k], ref[k])
    one = [_host(session.run_tiles(tiles[i:i + 1], **kw))
           for i in range(N_TILES)]
    for k in got:
        np.testing.assert_array_equal(
            got[k], np.concatenate([o[k] for o in one]), err_msg=k)


def test_two_batches_in_flight(sessions, monkeypatch):
    session, events = sessions['deepliif'], []
    forward, wait = session.forward, M._Pipeline.wait

    def counted_forward(tiles, **kw):
        events.append(('launch', tiles.shape[0]))
        return forward(tiles, **kw)

    def counted_wait(fetched):
        events.append(('collect', None))
        return wait(fetched)
    monkeypatch.setattr(session, 'forward', counted_forward)
    monkeypatch.setattr(M._Pipeline, 'wait', staticmethod(counted_wait))
    session.run_tiles(_tiles())
    kinds = [k for k, _ in events]
    # 28 non-empty tiles: three batches of 8 and a bucket of 4
    assert [b for k, b in events if k == 'launch'] == [8, 8, 8, 4]
    assert kinds == ['launch', 'launch', 'collect', 'launch', 'collect',
                     'launch', 'collect', 'collect']
    in_flight = np.cumsum([1 if k == 'launch' else -1 for k in kinds])
    assert in_flight.max() == 2 and in_flight[-1] == 0


def test_forward_error_reaches_caller(sessions, monkeypatch):
    """A forward that raises while another batch is in flight: the error
    reaches run_tiles' caller, and the dispatcher's caller, which keeps
    serving."""
    session = sessions['deepliif']
    forward, calls = session.forward, []

    def failing(tiles, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError('forward failed')
        return forward(tiles, **kw)
    monkeypatch.setattr(session, 'forward', failing)
    with pytest.raises(RuntimeError, match='forward failed'):
        session.run_tiles(_tiles())
    ds = DispatchSession(session)
    try:
        calls.clear()
        with pytest.raises(RuntimeError, match='forward failed'):
            ds.run_tiles(_tiles()[:17])
        out = ds.run_tiles(_tiles()[1:3])
        np.testing.assert_array_equal(
            out['GS'], session.run_tiles(_tiles()[1:3])['GS'])
    finally:
        ds.close()


def test_bucket_probe_on_cpu(sessions, monkeypatch):
    session = sessions['deepliif']
    monkeypatch.setattr(M.InferenceSession, '_PROBED_DEVICES',
                        ('cuda', 'cpu'))
    monkeypatch.setattr(session, 'bucket_probes', {})
    monkeypatch.setattr(session, '_probe_refs', {})
    tiles = _tiles()[1:4]
    plain = session.run_tiles(tiles)
    path = dict(seg_weights=None, mod_only=False, seg_only=False,
                return_intermediate=False, marker_index=None)
    assert session.batch_size(3, (64, 64, 3), path) == 4
    probes = {b: session.probe_bucket((64, 64, 3), path, b)
              for b in (1, 2, 4)}
    assert all(p['holds'] and not p['differs'] and not p['padded']
               for p in probes.values())
    assert session.batch_size(20, (64, 64, 3), path) == MAX_BATCH
    forwards = []
    forward = session.forward
    monkeypatch.setattr(session, 'forward', lambda t, **kw: forwards.append(
        t.shape[0]) or forward(t, **kw))
    for k, v in session.run_tiles(tiles).items():
        np.testing.assert_array_equal(v, plain[k])
    assert forwards == [4]              # probed once, in the first call

    # a bucket whose outputs differ from the full batch's is refused
    def perturbed(t, raw=False, **kw):
        res = forward(t, raw=raw, **kw)
        if raw and t.shape[0] == 2:
            res['seg'] = res['seg'] + 1e-3
        return res
    monkeypatch.setattr(session, 'forward', perturbed)
    session.bucket_probes.clear()
    probes = {b: session.probe_bucket((64, 64, 3), path, b)
              for b in (1, 2, 4)}
    assert not probes[2]['holds'] and probes[2]['differs'] == ['seg']
    assert probes[1]['holds'] and probes[4]['holds']
    assert [session.batch_size(n, (64, 64, 3), path)
            for n in (1, 2, 3, 5)] == [1, 4, 4, 8]


def test_batch_floors_pad_the_calls_that_differ():
    """The bucket's cuDNN hook: a call whose bits at a short batch differ
    from the full batch's (here: a function that adds 1e-3 below the full
    batch, as another algorithm would round otherwise) is found by the
    check, padded from then on, and keeps each sample's full-batch bits;
    the padding keeps the input's per-sample strides (channels_last); a
    bf16 call is always padded; a batch may lie on another axis."""
    def run(t):
        seen.append((t.shape[0], t.is_contiguous(
            memory_format=torch.channels_last)))
        return t * 2 + (0 if t.shape[0] == MAX_BATCH else 1e-3)
    seen = []
    x = torch.randn(3, 4, 5, 5).to(memory_format=torch.channels_last)
    floors = M._BatchFloors(MAX_BATCH, check=True)
    got = floors(run, x, 'k')
    assert floors.keys == ['k'] and torch.equal(got, x * 2)
    assert seen == [(3, True), (MAX_BATCH, True)]
    again = M._BatchFloors(MAX_BATCH, floors.keys)
    seen.clear()
    assert torch.equal(again(run, x, 'k'), x * 2) and seen == [(8, True)]
    assert torch.equal(again(run, x, 'other'), x * 2 + 1e-3)
    full = torch.randn(MAX_BATCH, 4, 5, 5)
    assert torch.equal(again(run, full, 'k'), full * 2)
    same = M._BatchFloors(MAX_BATCH, check=True)
    assert torch.equal(same(lambda t: t * 2, x, 'k'), x * 2)
    assert same.keys == []
    # a bf16 call is padded unchecked; a batch on axis 1 (the seg sum)
    seen.clear()
    xb = x.to(torch.bfloat16)
    assert torch.equal(same(run, xb, 'b'), xb * 2) and same.keys == ['b']
    assert seen == [(MAX_BATCH, True)]
    segs = torch.randn(5, 3, 4, 4)
    got = same(lambda t: t[0] - t[1] + (0 if t.shape[1] == MAX_BATCH
                                        else 1), segs, 's', axis=1)
    assert same.keys == ['b', 's'] and torch.equal(got, segs[0] - segs[1])


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_cuda_pipeline_and_buckets(cuda, dirs, case):
    """On the card: the pipelined 37 tiles byte-equal to the tiles one at
    a time and to the tiles in batches of ``max_batch``, and every bucket
    the session uses held by its probe."""
    family, kw = CASES[case]
    session = M.InferenceSession(dirs[family], device='cuda',
                                 max_batch=MAX_BATCH)
    tiles = _tiles()
    got = _host(session.run_tiles(tiles, **kw))
    one = [_host(session.run_tiles(tiles[i:i + 1], **kw))
           for i in range(N_TILES)]
    full = [_host(session.run_tiles(tiles[i:i + MAX_BATCH], **kw))
            for i in range(0, N_TILES, MAX_BATCH)]
    for k in got:
        np.testing.assert_array_equal(
            got[k], np.concatenate([o[k] for o in one]), err_msg=k)
        np.testing.assert_array_equal(
            got[k], np.concatenate([o[k] for o in full]), err_msg=k)
    probes = [p for v in session.bucket_probes.values() for p in v.values()]
    assert probes and all(p['holds'] for p in probes), probes
