"""The port's REST server (``deepliif_tpu_torch.serve``) and its dispatcher
against the JAX package's (CPU): the same tiny native model dir and the same
PNGs through both servers, the reference cloud contract cases of
tests/test_serve.py carried over to the port, and the dispatcher's
coalescing, batch cap, fairness and close with a fake session.

Tolerance of /api/infer: the modalities and Seg within 1 LSB on fewer than
0.1 % of pixels (tests/test_torch_port_inference.py); the port's overlays
and scoring equal to the JAX host quantifier run on the port's own Seg and
marker. /api/postprocess is byte-equal between the two servers. A request
coalesced with others gets the bytes it gets alone.

The ``cuda`` tests run the dispatcher on the card: coalesced against alone,
byte-equal, and the dispatcher thread's current CUDA device."""

import base64
import io
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as smoke
from deepliif_tpu import postprocessing as pp_jax
from deepliif_tpu.serve import make_handler as make_handler_jax
from deepliif_tpu_torch.models import deepliif as dl
from deepliif_tpu_torch.serve import make_handler, make_server, parse_multipart
from deepliif_tpu_torch.serve.dispatch import DispatchSession

TINY_CFG = {
    'model': 'DeepLIIF', 'modalities_no': 2, 'seg_gen': True, 'seg_no': 1,
    'input_no': 1, 'netG': 'resnet_6blocks', 'net_gs': 'unet_32', 'ngf': 8,
    'ndf': 8, 'norm': 'batch', 'no_dropout': False, 'padding': 'zero',
    'upsample': 'convtranspose', 'scale_size': 64,
    'seg_weights': [0.4, 0.3, 0.3],
    'modalities_names': ['IHC', 'ModA', 'Marker'],
    'background_colors': [(201, 211, 208), (10, 10, 10)],
}
# 10x: 128^2 tiles, a 64^2 request is one mirror-padded tile
QUERY = 'resolution=10x&prob_thresh=150'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One torch thread beside the suite's other workers (torch's per-op
    pool oversubscribes the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    """A tiny native DeepLIIF dir (weights at the reference init from a
    numpy seed), read by both packages."""
    md = str(tmp_path_factory.mktemp('serve_port_model'))
    d = dl.DeepLIIFDef(modalities_no=2, net_g=('resnet_6blocks',) * 2,
                       net_gs=('unet_32',) * 3, ngf=8,
                       seg_weights=(0.4, 0.3, 0.3))
    smoke.write_model_dir(md, dl.DeepLIIFNets(d), TINY_CFG, seed=7)
    return md


def _start(handler):
    srv = ThreadingHTTPServer(('127.0.0.1', 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f'http://127.0.0.1:{srv.server_address[1]}'


@pytest.fixture(scope='module')
def port_server(model_dir):
    srv = make_server(model_dir, '127.0.0.1', 0, device='cpu')
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv, f'http://127.0.0.1:{srv.server_address[1]}'
    srv.shutdown()


@pytest.fixture(scope='module')
def server(port_server):
    return port_server[1]


@pytest.fixture(scope='module')
def jax_server(model_dir):
    srv, url = _start(make_handler_jax(model_dir))
    yield url
    srv.shutdown()


def _multipart(files):
    boundary = 'testboundary123'
    body = b''
    for name, data in files.items():
        body += (f'--{boundary}\r\nContent-Disposition: form-data; '
                 f'name="{name}"; filename="{name}.png"\r\n'
                 f'Content-Type: image/png\r\n\r\n').encode() + data + b'\r\n'
    body += f'--{boundary}--\r\n'.encode()
    return body, f'multipart/form-data; boundary={boundary}'


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


def _post(url, files, timeout=300):
    body, ctype = _multipart(files)
    req = urllib.request.Request(url, data=body, method='POST',
                                 headers={'Content-Type': ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _img(seed, size=64):
    return smoke.ihc_like_image(size, seed)


def _assert_u8_close(a, b):
    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


# ---------------------------------------------------------------------------
# the port against the JAX server
# ---------------------------------------------------------------------------

def test_infer_matches_jax_server(server, jax_server):
    png = _png_bytes(_img(0))
    s_port, port = _post(f'{server}/api/infer?{QUERY}', {'img': png})
    s_jax, ref = _post(f'{jax_server}/api/infer?{QUERY}', {'img': png})
    assert s_port == s_jax == 200, (port, ref)
    assert set(port['images']) == set(ref['images']) == {
        'mod1-ModA', 'mod2-Marker', 'Seg', 'SegOverlaid', 'SegRefined'}
    got = {k: _decode(v) for k, v in port['images'].items()}
    for k in ('mod1-ModA', 'mod2-Marker', 'Seg'):
        _assert_u8_close(got[k], _decode(ref['images'][k]))
    # the JAX host quantifier on the port's own Seg and marker
    overlay, refined, scoring = pp_jax.compute_final_results(
        Image.open(io.BytesIO(png)).convert('RGB'), Image.fromarray(got['Seg']),
        pp_jax.to_array(Image.fromarray(got['mod2-Marker']), True), '10x',
        'default', None, None, 150)
    assert port['scoring'] == json.loads(json.dumps(scoring))
    np.testing.assert_array_equal(got['SegOverlaid'], overlay)
    np.testing.assert_array_equal(got['SegRefined'], refined)


@pytest.mark.parametrize('query,marker', [
    ('prob_thresh=150&size_thresh=0', False),
    ('resolution=20x&prob_thresh=100&size_thresh=auto&marker_thresh=auto',
     True),
    ('prob_thresh=120&size_thresh=5&size_thresh_upper=400&marker_thresh=80',
     True)])
def test_postprocess_byte_equal_to_jax_server(server, jax_server, query,
                                              marker):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (64, 64, 3), np.uint8)
    seg = np.zeros((64, 64, 3), np.uint8)
    seg[10:20, 10:20] = (200, 0, 0)     # positive blob
    seg[40:50, 40:50] = (0, 0, 200)     # negative blob
    seg[30:33, 5:60] = (0, 200, 0)      # boundary
    files = {'img': _png_bytes(img), 'seg_img': _png_bytes(seg)}
    if marker:
        files['marker_img'] = _png_bytes(
            rng.integers(0, 255, (64, 64, 3), np.uint8))
    s_port, port = _post(f'{server}/api/postprocess?{query}', files)
    s_jax, ref = _post(f'{jax_server}/api/postprocess?{query}', files)
    assert s_port == s_jax == 200, (port, ref)
    assert port == ref
    assert port['scoring']['num_total'] >= 1


# ---------------------------------------------------------------------------
# the reference cloud contract (tests/test_serve.py), on the port
# ---------------------------------------------------------------------------

def test_healthz(server):
    health = _get(server + '/healthz')
    assert health['status'] == 'ok'
    # make_server loaded the session before it answered
    assert 'dispatch' in health


def test_infer_slim_returns_only_refined(server):
    status, data = _post(f'{server}/api/infer?slim&{QUERY}',
                         {'img': _png_bytes(_img(1))})
    assert status == 200
    assert set(data['images']) == {'SegRefined'}


def test_infer_nopost_returns_no_scoring(server):
    status, data = _post(f'{server}/api/infer?nopost&{QUERY}',
                         {'img': _png_bytes(_img(1))})
    assert status == 200
    assert data['scoring'] is None
    assert 'SegRefined' not in data['images'] and 'Seg' in data['images']


def test_infer_missing_img_is_400(server):
    status, data = _post(server + '/api/infer', {'other': b'abc'})
    assert status == 400
    assert 'img' in data['error']


def test_unknown_endpoint_404(server):
    status, _ = _post(server + '/api/bogus', {'img': b'x'})
    assert status == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server + '/api/nothing')
    assert e.value.code == 404


@pytest.mark.parametrize('payload', [b'hello', b'\x00\x01binary\xff',
                                     b'ends in crlf\r\n', b'--', b''])
def test_multipart_parser_roundtrip(payload):
    body, ctype = _multipart({'a': payload, 'b': b'second'})
    fields = parse_multipart(body, ctype)
    assert fields == {'a': payload, 'b': b'second'}


def test_batch_infer_poll_contract(server):
    png = _png_bytes(_img(5))
    status, data = _post(f'{server}/api/batch/infer?{QUERY}&pil=true',
                         {'img': png})
    assert status == 200 and 'task_id' in data
    st = {'state': 'PENDING'}
    for _ in range(600):
        st = _get(f'{server}/api/batch/infer/{data["task_id"]}')
        if st['state'] != 'PENDING':
            break
        time.sleep(0.1)
    assert st['state'] == 'SUCCESS', st
    # the same payload as the synchronous endpoint
    status, sync = _post(f'{server}/api/infer?{QUERY}&pil=true', {'img': png})
    assert st['result'] == sync


def test_batch_infer_unknown_task_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server + '/api/batch/infer/deadbeef')
    assert e.value.code == 404


def test_batch_task_eviction(model_dir):
    """Completed batch tasks are evicted beyond max_retained_tasks."""
    srv, base = _start(make_handler(model_dir, max_retained_tasks=3,
                                    device='cpu'))
    try:
        tids = []
        for i in range(6):
            status, data = _post(f'{base}/api/batch/infer?{QUERY}',
                                 {'img': _png_bytes(_img(10 + i))})
            assert status == 200
            tids.append(data['task_id'])
        deadline = time.time() + 120
        while time.time() < deadline:
            states = []
            for tid in tids:
                try:
                    states.append(_get(f'{base}/api/batch/infer/{tid}')
                                  ['state'])
                except urllib.error.HTTPError:
                    states.append('EVICTED')
            if 'PENDING' not in states:
                break
            time.sleep(0.2)
        assert 'PENDING' not in states
        assert states.count('EVICTED') >= 3, states
    finally:
        srv.shutdown()


def test_batch_pending_cap_rejects(model_dir):
    srv, base = _start(make_handler(model_dir, max_pending_tasks=0,
                                    device='cpu'))
    try:
        status, data = _post(f'{base}/api/batch/infer?{QUERY}',
                             {'img': _png_bytes(_img(3))})
        assert status == 503
        assert 'retry' in data['error']
    finally:
        srv.shutdown()


def test_oversized_image_is_400(model_dir):
    srv, base = _start(make_handler(model_dir, max_image_dim=128,
                                    device='cpu'))
    try:
        big = np.zeros((256, 256, 3), np.uint8)
        small = np.zeros((64, 64, 3), np.uint8)
        status, data = _post(base + '/api/infer', {'img': _png_bytes(big)})
        assert status == 400 and '128x128' in data['error']
        for files, name in (
                ({'img': big, 'seg_img': big}, 'img'),
                ({'img': small, 'seg_img': big}, 'seg_img'),
                ({'img': small, 'seg_img': small, 'marker_img': big},
                 'marker_img')):
            status, data = _post(base + '/api/postprocess',
                                 {k: _png_bytes(v) for k, v in files.items()})
            assert status == 400 and f"'{name}'" in data['error']
    finally:
        srv.shutdown()


def test_oversized_body_is_413(model_dir):
    srv, base = _start(make_handler(model_dir, max_body_bytes=1024,
                                    device='cpu'))
    try:
        img = np.random.default_rng(0).integers(0, 255, (64, 64, 3), np.uint8)
        status, data = _post(base + '/api/infer', {'img': _png_bytes(img)})
        assert status == 413 and 'limit' in data['error']
    finally:
        srv.shutdown()


def test_request_timeout_is_504(model_dir):
    srv, base = _start(make_handler(model_dir, request_timeout=1e-3,
                                    device='cpu'))
    try:
        status, data = _post(base + '/api/infer',
                             {'img': _png_bytes(_img(4))})
        assert status == 504 and 'budget' in data['error']
    finally:
        srv.shutdown()


def _coalesced_then_alone(srv, url, pngs, tile):
    """``pngs`` posted concurrently while the dispatcher waits on its device
    lock behind an empty ``tile``-sized blocker (no forward: empty tiles are
    skipped), so that they queue together; then each posted alone. Returns
    (concurrent responses, lone responses, dispatch stats of the concurrent
    part)."""
    ds = srv.RequestHandlerClass.get_session()
    before = dict(ds.stats)
    out = [None] * len(pngs)

    def client(i):
        out[i] = _post(f'{url}/api/infer?{QUERY}', {'img': pngs[i]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(pngs))]
    blocker = threading.Thread(target=ds.run_tiles, args=(
        np.zeros((1, tile, tile, 3), np.uint8),))
    with ds._device_lock:
        blocker.start()
        deadline = time.time() + 30
        while ds._q.qsize() and time.time() < deadline:
            time.sleep(0.005)
        time.sleep(0.05)        # the dispatcher waits on the lock now
        for t in threads:
            t.start()
        while ds._q.qsize() < len(pngs) and time.time() < deadline:
            time.sleep(0.01)
    for t in threads + [blocker]:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads + [blocker])
    stats = {k: ds.stats[k] - before[k] for k in ('device_calls',
                                                  'coalesced_calls')}
    alone = [_post(f'{url}/api/infer?{QUERY}', {'img': p}) for p in pngs]
    return out, alone, stats


def test_concurrent_requests_coalesce_and_match_alone(port_server):
    """Concurrent /api/infer requests share device calls, and each gets the
    bytes it gets alone (on the CPU each conv runs on one sample)."""
    srv, url = port_server
    pngs = [_png_bytes(_img(20 + i)) for i in range(5)]
    out, alone, stats = _coalesced_then_alone(srv, url, pngs, 128)
    assert stats['coalesced_calls'] >= 1, stats
    assert stats['device_calls'] <= 2, stats
    for (s, data), (s1, data1) in zip(out, alone):
        assert s == s1 == 200, data
        assert data == data1
    assert _get(url + '/healthz')['dispatch']['coalesced_calls'] >= 1


def test_serve_entry_points_pass_their_options(model_dir, monkeypatch):
    """``deepliif-tpu-torch serve`` and ``python -m deepliif_tpu_torch.serve``
    hand the session options to ``make_server`` (the CLI also the JAX
    package's int8 calibration settings from the environment)."""
    from click.testing import CliRunner
    from deepliif_tpu_torch import cli, serve

    calls = []

    class Server:
        server_address = ('127.0.0.1', 1234)

        def serve_forever(self):
            pass

    monkeypatch.setattr(serve, 'make_server',
                        lambda *a, **k: calls.append((a, k)) or Server())
    monkeypatch.setenv('DEEPLIIF_INT8_CALIBRATE', '0')
    res = CliRunner().invoke(cli.make_cli(), [
        'serve', '--model-dir', model_dir, '--port', '0', '--device', 'cpu',
        '--precision', 'int8', '--int8-scope', 'resblocks', '--max-batch',
        '4', '--request-timeout', '0'])
    assert res.exit_code == 0, res.output
    assert 'on cpu, 0.0.0.0:1234' in res.output
    serve.main(['--model-dir', model_dir, '--device', 'cpu',
                '--precision', 'bfloat16', '--fuse-stages'])
    (a1, k1), (a2, k2) = calls
    assert a1 == (model_dir, '0.0.0.0', 0, 4, 'int8', 4096, None, 'cpu',
                  'resblocks', None, False, 100.0)
    assert a2 == (model_dir, '0.0.0.0', 8080, None, 'bfloat16', 4096, 60.0,
                  'cpu', None, True, True, 100.0)


def _int8_server(model_dir, tmp_path, device):
    """A server at --precision int8 on a copy of the tiny dir (it writes
    act_scales.json there)."""
    md = str(tmp_path / 'int8_model')
    shutil.copytree(model_dir, md)
    srv = make_server(md, '127.0.0.1', 0, device=device, precision='int8')
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return md, srv, f'http://127.0.0.1:{srv.server_address[1]}'


def test_int8_server_calibrates_on_the_first_device_call(model_dir,
                                                         tmp_path):
    """An int8 server without act_scales.json calibrates static scales on
    the tiles of its first device call and writes them, as the JAX session
    does; later requests run on those scales."""
    md, srv, url = _int8_server(model_dir, tmp_path, 'cpu')
    try:
        assert not os.path.exists(os.path.join(md, 'act_scales.json'))
        png = _png_bytes(_img(30))
        status, first = _post(f'{url}/api/infer?{QUERY}', {'img': png})
        assert status == 200, first
        with open(os.path.join(md, 'act_scales.json')) as f:
            saved = json.load(f)
        assert saved['n_tiles'] == 1 and saved['scales']
        session = srv.RequestHandlerClass.get_session()._session
        assert session.act_scales == saved['scales']
        assert _post(f'{url}/api/infer?{QUERY}', {'img': png})[1] == first
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the dispatcher with a fake session (tests/test_serve.py's cases)
# ---------------------------------------------------------------------------

class _FakeSession:
    """Stand-in for InferenceSession: output == input tiles, with a sleep
    long enough that concurrent callers pile up in the queue."""

    def __init__(self, max_batch=64, delay=0.15, device=None):
        self.opt = None
        self.d = None
        self.family = 'deepliif'
        self.model_dir = 'fake'
        self.max_batch = max_batch
        self.delay = delay
        self.device = device
        self.batch_sizes = []
        self.current_devices = []

    def run_tiles(self, tiles, seg_weights=None, seg_only=False,
                  mod_only=False, return_intermediate=False, device_keys=()):
        if self.device is not None and self.device.type == 'cuda':
            self.current_devices.append(torch.cuda.current_device())
        self.batch_sizes.append(len(tiles))
        time.sleep(self.delay)
        return {'G1': tiles.copy()}


def _clients(ds, inputs):
    results = [None] * len(inputs)

    def client(i):
        results[i] = ds.run_tiles(inputs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return results


def test_dispatch_session_coalesces_concurrent_requests():
    fake = _FakeSession()
    ds = DispatchSession(fake)
    rng = np.random.default_rng(0)
    inputs = [rng.integers(0, 255, (3, 8, 8, 3), np.uint8) for _ in range(6)]
    results = _clients(ds, inputs)
    for got, want in zip(results, inputs):
        np.testing.assert_array_equal(got['G1'], want)
    assert ds.stats['coalesced_calls'] >= 1, (ds.stats, fake.batch_sizes)
    assert ds.stats['max_requests_per_call'] > 1
    assert sum(fake.batch_sizes) == 18
    assert len(fake.batch_sizes) < 6
    ds.close()


def test_dispatch_session_respects_max_batch():
    fake = _FakeSession(max_batch=4, delay=0.1)
    ds = DispatchSession(fake)
    rng = np.random.default_rng(1)
    _clients(ds, [rng.integers(0, 255, (3, 8, 8, 3), np.uint8)
                  for _ in range(5)])
    assert all(b <= 4 for b in fake.batch_sizes), fake.batch_sizes
    ds.close()


def test_dispatch_session_close_during_traffic_terminates_thread():
    fake = _FakeSession(delay=0.05)
    ds = DispatchSession(fake)
    rng = np.random.default_rng(2)
    inputs = [rng.integers(0, 255, (2, 8, 8, 3), np.uint8) for _ in range(4)]
    results, errors = [None] * 4, [None] * 4

    def client(i):
        try:
            results[i] = ds.run_tiles(inputs[i])
        except Exception as e:  # noqa: BLE001 — close() may reject late ones
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    ds.close()
    for t in threads:
        t.join(timeout=30)
    ds._thread.join(timeout=10)
    assert not ds._thread.is_alive()
    for i in range(4):
        assert (results[i] is not None) or (errors[i] is not None), i
        if results[i] is not None:
            np.testing.assert_array_equal(results[i]['G1'], inputs[i])
    with pytest.raises(RuntimeError, match='closed'):
        ds.run_tiles(inputs[0])


def test_dispatch_fairness_oldest_first():
    fake = _FakeSession(max_batch=8, delay=0.25)
    ds = DispatchSession(fake)
    done = []

    def client(tag, shape, delay):
        time.sleep(delay)
        ds.run_tiles(np.zeros((2,) + shape + (3,), np.uint8))
        done.append(tag)

    threads = [
        threading.Thread(target=client, args=('A0', (8, 8), 0.0)),
        threading.Thread(target=client, args=('B', (4, 4), 0.08)),
        threading.Thread(target=client, args=('A1', (8, 8), 0.14)),
        threading.Thread(target=client, args=('A2', (8, 8), 0.17)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    ds.close()
    assert done[0] == 'A0'
    assert done[1] == 'B', (done, fake.batch_sizes)
    assert len(fake.batch_sizes) == 3, fake.batch_sizes


def test_dispatch_fairness_under_sustained_load():
    fake = _FakeSession(max_batch=16, delay=0.04)
    ds = DispatchSession(fake)
    stop = threading.Event()

    def hog():
        while not stop.is_set():
            ds.run_tiles(np.zeros((2, 8, 8, 3), np.uint8))

    hogs = [threading.Thread(target=hog, daemon=True) for _ in range(4)]
    for t in hogs:
        t.start()
    time.sleep(0.2)
    t0 = time.time()
    out = ds.run_tiles(np.zeros((1, 4, 4, 3), np.uint8))
    latency = time.time() - t0
    stop.set()
    for t in hogs:
        t.join(timeout=10)
    ds.close()
    assert out['G1'].shape == (1, 4, 4, 3)
    assert latency < 1.0, latency


def test_dispatch_errors_reach_every_caller():
    """A failing device call resolves each request of its group with the
    error, and the dispatcher goes on serving."""
    class Failing(_FakeSession):
        def run_tiles(self, tiles, **kw):
            if tiles.shape[1] == 4:
                raise ValueError('bad tiles')
            return super().run_tiles(tiles, **kw)

    ds = DispatchSession(Failing(delay=0.0))
    with pytest.raises(ValueError, match='bad tiles'):
        ds.run_tiles(np.zeros((1, 4, 4, 3), np.uint8))
    assert ds.run_tiles(np.ones((1, 8, 8, 3), np.uint8))['G1'].sum() == 192
    ds.close()


def test_dispatch_facade_exposes_what_inference_reads():
    fake = _FakeSession(device=torch.device('cpu'))
    ds = DispatchSession(fake)
    for name in ('opt', 'd', 'family', 'model_dir', 'max_batch', 'device'):
        assert getattr(ds, name) is getattr(fake, name)
    ds.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
def test_cuda_dispatcher_thread_enters_the_session_device(cuda):
    """The dispatcher thread's current CUDA device is the session's (the
    hand kernels launch on the current device's current stream)."""
    device = torch.device('cuda', torch.cuda.device_count() - 1)
    fake = _FakeSession(delay=0.0, device=device)
    ds = DispatchSession(fake)
    ds.run_tiles(np.zeros((1, 8, 8, 3), np.uint8))
    ds.run_tiles(np.zeros((1, 8, 8, 3), np.uint8), return_intermediate=True)
    ds.close()
    assert fake.current_devices == [device.index] * 2


@pytest.mark.cuda
def test_cuda_int8_server_runs_the_int8_kernels(cuda, model_dir, tmp_path):
    """``serve --precision int8`` on the card: calibrated on the first
    call, the quantized convs on ``conv_s8``, byte-equal run to run."""
    from deepliif_tpu_torch.ops import conv_int8
    md, srv, url = _int8_server(model_dir, tmp_path, 'cuda')
    try:
        png = _png_bytes(_img(31, size=200))
        before = conv_int8.conv_s8.launches
        status, first = _post(f'{url}/api/infer?{QUERY}', {'img': png})
        assert status == 200, first
        assert conv_int8.conv_s8.launches > before
        assert os.path.exists(os.path.join(md, 'act_scales.json'))
        assert _post(f'{url}/api/infer?{QUERY}', {'img': png})[1] == first
    finally:
        srv.shutdown()


@pytest.mark.cuda
def test_cuda_coalesced_requests_byte_equal_alone(cuda, model_dir):
    srv = make_server(model_dir, '127.0.0.1', 0, device='cuda')
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f'http://127.0.0.1:{srv.server_address[1]}'
        pngs = [_png_bytes(_img(40 + i, size=200)) for i in range(6)]
        out, alone, stats = _coalesced_then_alone(srv, url, pngs, 128)
        assert stats['coalesced_calls'] >= 1, stats
        for (s, data), (s1, data1) in zip(out, alone):
            assert s == s1 == 200, data
            assert data == data1
    finally:
        srv.shutdown()
