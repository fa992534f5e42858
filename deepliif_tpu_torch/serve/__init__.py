"""REST serving: the reference cloud API contract, self-hosted; the port's
counterpart of deepliif_tpu/serve/__init__.py.

Implements the deepliif.org endpoints (reference README.md:308-463) so the
unchanged ImageJ plugin and client scripts work against the port:

  POST /api/infer        multipart 'img' + query resolution/pil/slim/nopost/
                         prob_thresh/size_thresh/size_thresh_upper/
                         marker_thresh -> {'images': {name: b64 png},
                         'scoring': {...}}
  POST /api/batch/infer  the same, asynchronous: -> {'task_id'}; GET
                         /api/batch/infer/<id> polls it
  POST /api/postprocess  multipart 'img' + 'seg_img' [+ 'marker_img'] +
                         the same thresholds -> images + scoring
  GET  /healthz          status and the dispatcher's counts

Built on the stdlib ThreadingHTTPServer; the model is one cached
InferenceSession on ``device`` (default cuda) behind a ``DispatchSession``,
so concurrent requests share its device calls while decode, tiling, the
host quantifier and PNG encode run on the request threads. ``serve`` loads
the session and builds its CUDA kernels before it answers; ``make_handler``
alone loads them at the first request.

    python -m deepliif_tpu_torch.serve --model-dir model --port 8080 \\
        [--device cuda|cpu] [--precision int8 --int8-scope all]
"""

from __future__ import annotations

import base64
import io
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

RESOLUTION_TILE_SIZE = {'40x': 512, '20x': 256, '10x': 128}


class _BadRequest(ValueError):
    """Client-visible request validation error -> HTTP 400."""


class _Timeout(RuntimeError):
    """Per-request budget exceeded -> HTTP 504 (the reference cloud's
    behavior beyond its ~60 s budget, reference README.md:406)."""


def _run_with_deadline(fn, timeout):
    """Run fn() with a wall-clock budget. On timeout the worker thread is
    abandoned (daemon; the device call it may hold finishes and warms the
    jit cache for the retry) and the caller gets _Timeout -> 504."""
    if not timeout:
        return fn()
    box = {}

    def run():
        try:
            box['r'] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in caller
            box['e'] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise _Timeout(f'request exceeded the {timeout:.0f}s budget')
    if 'e' in box:
        raise box['e']
    return box['r']


def parse_multipart(body, content_type):
    """Minimal multipart/form-data parser -> {field_name: bytes}.

    Content bytes are preserved exactly: the CRLF before each boundary
    belongs to the DELIMITER (RFC 2046 §5.1.1), so splitting on
    b'\\r\\n--boundary' removes precisely it — an rstrip would corrupt
    binary uploads whose payload happens to end in CR/LF or '--'."""
    m = re.search(r'boundary=("?)([^";]+)\1', content_type)
    if not m:
        raise ValueError('no multipart boundary')
    delim = b'--' + m.group(2).encode()
    if body.startswith(delim):
        body = b'\r\n' + body   # first delimiter carries no preceding CRLF
    fields = {}
    for seg in body.split(b'\r\n' + delim)[1:]:
        if seg.startswith(b'--'):
            break               # closing delimiter
        if seg.startswith(b'\r\n'):
            seg = seg[2:]
        elif seg.startswith(b'\n'):
            seg = seg[1:]       # tolerate bare-LF transports
        headers, sep, content = seg.partition(b'\r\n\r\n')
        if not sep:
            continue
        nm = re.search(rb'name="([^"]+)"', headers)
        if nm:
            fields[nm.group(1).decode()] = content
    return fields


def _b64_png(img):
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


def _parse_thresholds(q):
    def first(key, default=None):
        return q.get(key, [default])[0]

    prob_thresh = int(first('prob_thresh', 150))
    size_thresh = first('size_thresh', 'auto')
    if size_thresh == 'auto':
        size_thresh = 'default'
    elif size_thresh != 'default':
        size_thresh = int(size_thresh)
    size_up = first('size_thresh_upper', 'none')
    size_up = None if size_up in ('none', None) else int(size_up)
    marker_thresh = first('marker_thresh', 'none')
    if marker_thresh in ('none', None):
        marker_thresh = None
    elif marker_thresh == 'auto':
        marker_thresh = 'default'
    else:
        marker_thresh = int(marker_thresh)
    return prob_thresh, size_thresh, size_up, marker_thresh


def make_handler(model_dir, max_batch=None, batch_workers=4,
                 max_retained_tasks=512, max_pending_tasks=256,
                 precision=None, max_image_dim=4096, max_body_bytes=None,
                 request_timeout=60.0, device='cuda', int8_scope=None,
                 fuse_stages=None, int8_calibrate=True, int8_calib_pct=100.0):
    """max_image_dim: reject images beyond this per side with 400 — the
    reference cloud's own clients are bounded at 4096x4096
    (DeepliifClient.java:23-24); larger inputs belong on the test-wsi path.
    max_body_bytes: reject bodies beyond this with 413 before decoding
    (default: enough for THREE max_image_dim RGBA PNGs plus multipart
    framing — /api/postprocess legitimately carries img + seg_img +
    marker_img in one body).
    request_timeout: per-request wall-clock budget in seconds -> 504, the
    reference cloud contract (README.md:406). None/0 disables.
    ``device``, ``precision``, ``int8_scope``, ``fuse_stages``,
    ``int8_calibrate`` and ``int8_calib_pct`` go to the session
    (``models.init_nets``). The session is loaded, and its CUDA kernels
    built, at the first request, or by ``Handler.get_session()`` (what
    ``serve`` calls before it answers). An int8 session without
    act_scales.json calibrates on the first device call's tiles."""
    if max_body_bytes is None:
        max_body_bytes = 3 * 4 * max_image_dim * max_image_dim + (1 << 20)
    from collections import OrderedDict
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from .. import postprocessing as pp
    from ..models import init_nets, find_marker_key
    from .dispatch import DispatchSession

    # One model, but requests run CONCURRENTLY: decode, tiling, postprocess
    # and PNG encode all happen on the HTTP threads in parallel, and
    # concurrent tile batches are coalesced into shared device calls by
    # DispatchSession (the reference gets concurrency from TorchServe worker
    # processes, model-server/config.properties).
    init_lock = threading.Lock()
    dispatch = {}

    def get_session():
        if 'ds' not in dispatch:
            with init_lock:
                if 'ds' not in dispatch:
                    session = init_nets(
                        model_dir, max_batch=max_batch, precision=precision,
                        device=device, int8_scope=int8_scope,
                        fuse_stages=fuse_stages,
                        int8_calibrate=int8_calibrate,
                        int8_calib_pct=int8_calib_pct)
                    session.build_kernels()
                    dispatch['ds'] = DispatchSession(session)
        return dispatch['ds']

    # async batch tasks for the ImageJ plugin contract:
    # POST /api/batch/infer -> {'task_id'}; GET /api/batch/infer/<id> ->
    # {'state': PENDING|SUCCESS|FAILURE, 'result': ...}
    # Bounded: a fixed worker pool (no thread-per-request) and an LRU of
    # retained results — completed tasks are evicted oldest-first beyond
    # max_retained_tasks, so sustained use cannot leak memory.
    tasks = OrderedDict()
    tasks_lock = threading.Lock()
    pool = ThreadPoolExecutor(max_workers=batch_workers,
                              thread_name_prefix='batch-infer')

    def _store_task(task_id, payload):
        with tasks_lock:
            tasks[task_id] = payload
            tasks.move_to_end(task_id)
            while len(tasks) > max_retained_tasks:
                # evict the oldest COMPLETED task; stop if only pending left
                for k, v in tasks.items():
                    if v['state'] != 'PENDING':
                        del tasks[k]
                        break
                else:
                    break

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path in ('/healthz', '/'):
                payload = {'status': 'ok', 'model_dir': model_dir}
                if 'ds' in dispatch:
                    payload['dispatch'] = dict(dispatch['ds'].stats)
                self._json(200, payload)
                return
            m = re.match(r'^/api/batch/infer/([\w-]+)$', path)
            if m:
                with tasks_lock:
                    task = tasks.get(m.group(1))
                if task is None:
                    self._json(404, {'error': 'unknown task'})
                else:
                    self._json(200, task)
                return
            self._json(404, {'error': 'not found'})

        def do_POST(self):
            try:
                url = urlparse(self.path)
                q = parse_qs(url.query, keep_blank_values=True)
                length = int(self.headers.get('Content-Length', 0))
                if length > max_body_bytes:
                    # refuse before buffering: a multi-GB upload must not
                    # occupy server memory just to be rejected
                    self._json(413, {'error':
                                     f'request body {length} bytes exceeds '
                                     f'the {max_body_bytes}-byte limit'})
                    return
                body = self.rfile.read(length)
                fields = parse_multipart(body, self.headers.get('Content-Type', ''))

                if url.path == '/api/infer':
                    self._infer(fields, q)
                elif url.path == '/api/batch/infer':
                    self._batch_infer(fields, q)
                elif url.path == '/api/postprocess':
                    self._postprocess(fields, q)
                else:
                    self._json(404, {'error': f'unknown endpoint {url.path}'})
            except Exception as e:  # noqa: BLE001 — report to client
                self._json(500, {'error': f'{type(e).__name__}: {e}'})

        @staticmethod
        def _open_checked(data, name):
            """Open + dimension-check BEFORE decoding pixels: PIL's open
            is lazy (header only), so an oversized image is rejected
            without paying its decode (a tiny flat-color PNG can expand
            to hundreds of MB — the limit must run first)."""
            im = Image.open(io.BytesIO(data))
            if max(im.size) > max_image_dim:
                raise _BadRequest(
                    f"'{name}' {im.size[0]}x{im.size[1]} exceeds the "
                    f'{max_image_dim}x{max_image_dim} request limit '
                    f'(use the WSI pipeline for larger inputs)')
            return im

        @classmethod
        def _infer_payload(cls, fields, q):
            if 'img' not in fields:
                raise _BadRequest("missing file parameter 'img'")
            img = cls._open_checked(fields['img'], 'img').convert('RGB')
            resolution = q.get('resolution', ['40x'])[0]
            tile_size = RESOLUTION_TILE_SIZE.get(resolution, 512)
            slim = 'slim' in q
            nopost = 'nopost' in q
            prob_thresh, size_thresh, size_up, marker_thresh = _parse_thresholds(q)

            from ..models import inference
            session = get_session()
            images = inference(img, tile_size=tile_size,
                               overlap_size=tile_size // 16,
                               model_path=model_dir, opt=session.opt,
                               session=session,
                               mod_only=not getattr(session.opt, 'seg_gen', True))
            scoring = None
            if not nopost and 'Seg' in images:
                marker = images.get(find_marker_key(images))
                overlay, refined, scoring = pp.compute_final_results(
                    img, images['Seg'],
                    pp.to_array(marker, True) if marker is not None else None,
                    resolution, size_thresh, marker_thresh, size_up,
                    prob_thresh)
                images['SegOverlaid'] = Image.fromarray(overlay)
                images['SegRefined'] = Image.fromarray(refined)
            if slim:
                images = {k: v for k, v in images.items() if k == 'SegRefined'}
            return {'images': {k: _b64_png(v) for k, v in images.items()},
                    'scoring': scoring}

        def _infer(self, fields, q):
            try:
                self._json(200, _run_with_deadline(
                    lambda: self._infer_payload(fields, q), request_timeout))
            except _BadRequest as e:
                # only OUR validation errors are client errors — a broad
                # KeyError catch would report internal dict-lookup bugs
                # (e.g. an unregistered model name) as 400s
                self._json(400, {'error': str(e)})
            except _Timeout as e:
                self._json(504, {'error': str(e)})

        def _batch_infer(self, fields, q):
            """Async submit + poll (the ImageJ plugin contract,
            DeepliifClient.java:29-125)."""
            import uuid
            if 'img' not in fields:
                self._json(400, {'error': "missing file parameter 'img'"})
                return
            with tasks_lock:
                pending = sum(1 for v in tasks.values()
                              if v['state'] == 'PENDING')
            if pending >= max_pending_tasks:
                # PENDING tasks (each closure holds the request body) must
                # be bounded too, or a submit flood OOMs the server
                self._json(503, {'error': 'batch queue full, retry later'})
                return
            task_id = uuid.uuid4().hex
            _store_task(task_id, {'state': 'PENDING', 'result': None})

            payload_fn = self._infer_payload

            def work():
                try:
                    result = _run_with_deadline(
                        lambda: payload_fn(fields, q), request_timeout)
                    _store_task(task_id, {'state': 'SUCCESS', 'result': result})
                except Exception as e:  # noqa: BLE001
                    _store_task(task_id, {'state': 'FAILURE',
                                          'result': {'error': str(e)}})

            pool.submit(work)
            self._json(200, {'task_id': task_id})

        def _postprocess(self, fields, q):
            try:
                for req in ('img', 'seg_img'):
                    if req not in fields:
                        raise _BadRequest(f"missing file parameter '{req}'")
                # every image in the body gets the dimension gate, not just
                # 'img' — an oversized seg_img would otherwise smuggle a
                # 256 MPx quantification past the request limit
                img = self._open_checked(fields['img'], 'img').convert('RGB')
                seg = self._open_checked(fields['seg_img'],
                                         'seg_img').convert('RGB')
                marker = None
                if 'marker_img' in fields:
                    # max-over-RGB, the reference grayscale convention
                    marker = pp.to_array(
                        self._open_checked(fields['marker_img'],
                                           'marker_img'), True)
            except _BadRequest as e:
                self._json(400, {'error': str(e)})
                return
            resolution = q.get('resolution', ['40x'])[0]
            prob_thresh, size_thresh, size_up, marker_thresh = _parse_thresholds(q)

            def run():
                overlay, refined, scoring = pp.compute_final_results(
                    img, seg, marker, resolution, size_thresh, marker_thresh,
                    size_up, prob_thresh)
                return {
                    'images': {
                        'SegOverlaid': _b64_png(Image.fromarray(overlay)),
                        'SegRefined': _b64_png(Image.fromarray(refined)),
                    },
                    'scoring': scoring,
                }

            try:
                self._json(200, _run_with_deadline(run, request_timeout))
            except _Timeout as e:
                self._json(504, {'error': str(e)})

    Handler.get_session = staticmethod(get_session)
    return Handler


def make_server(model_dir, host='0.0.0.0', port=8080, max_batch=None,
                precision=None, max_image_dim=4096, request_timeout=60.0,
                device='cuda', int8_scope=None, fuse_stages=None,
                int8_calibrate=True, int8_calib_pct=100.0):
    """A ThreadingHTTPServer on (host, port) (port 0: any free port,
    ``server_address`` says which) whose session is loaded and whose CUDA
    kernels are built: a build at first use is not charged to the first
    request's budget."""
    handler = make_handler(model_dir, max_batch=max_batch,
                           precision=precision, max_image_dim=max_image_dim,
                           request_timeout=request_timeout, device=device,
                           int8_scope=int8_scope, fuse_stages=fuse_stages,
                           int8_calibrate=int8_calibrate,
                           int8_calib_pct=int8_calib_pct)
    handler.get_session()
    return ThreadingHTTPServer((host, port), handler)


def serve(model_dir, host='0.0.0.0', port=8080, max_batch=None,
          precision=None, max_image_dim=4096, request_timeout=60.0,
          device='cuda', int8_scope=None, fuse_stages=None,
          int8_calibrate=True, int8_calib_pct=100.0):
    server = make_server(model_dir, host, port, max_batch, precision,
                         max_image_dim, request_timeout, device, int8_scope,
                         fuse_stages, int8_calibrate, int8_calib_pct)
    print(f'serving DeepLIIF model {model_dir} on {device}, '
          f'{host}:{server.server_address[1]}', flush=True)
    server.serve_forever()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description='DeepLIIF REST server on '
                                             'PyTorch and CUDA')
    ap.add_argument('--model-dir', required=True)
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--port', type=int, default=8080)
    ap.add_argument('--max-batch', type=int, default=None)
    ap.add_argument('--max-image-dim', type=int, default=4096,
                    help='reject larger images with 400 (reference client '
                         'bound, DeepliifClient.java:23-24)')
    ap.add_argument('--request-timeout', type=float, default=60.0,
                    help='per-request budget in seconds -> 504 '
                         '(reference cloud contract, README.md:406); '
                         '0 disables')
    ap.add_argument('--device', default='cuda',
                    help='torch device to run on, e.g. cuda, cuda:1 or cpu')
    ap.add_argument('--precision', default=None,
                    choices=['float32', 'bfloat16', 'int8'],
                    help='override the model dir compute precision')
    ap.add_argument('--int8-scope', default=None, choices=['all', 'resblocks'],
                    help='which convs --precision int8 quantizes')
    ap.add_argument('--fuse-stages', action='store_true', default=None,
                    help="run the translators' fused stages (bfloat16)")
    args = ap.parse_args(argv)
    serve(args.model_dir, args.host, args.port, args.max_batch,
          precision=args.precision, max_image_dim=args.max_image_dim,
          request_timeout=args.request_timeout or None, device=args.device,
          int8_scope=args.int8_scope, fuse_stages=args.fuse_stages)
