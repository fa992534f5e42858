"""Micro-batching device dispatcher for concurrent serving: the port's copy
of deepliif_tpu/serve/dispatch.py.

Many HTTP threads are in flight at once (decode, tiling, postprocess and PNG
encode run in parallel on them), and their tile batches are coalesced into
shared device calls. ``DispatchSession`` wraps an InferenceSession:
``run_tiles`` enqueues the caller's tiles and blocks on a per-request
event; one dispatcher thread drains whatever is queued when the device
frees up (no artificial batching delay) into one
``InferenceSession.run_tiles`` call, then splits the outputs back per
request. Requests with other settings (seg_weights, flags, tile shape) are
grouped by those settings; requests for device-kept outputs or the seg
intermediates bypass coalescing.

On a CUDA session every device call runs inside
``torch.cuda.device(session.device)``: the hand kernels launch on
``torch.cuda.current_stream()``, and the CUDA runtime's current device is
per thread. A coalesced request gets the bytes it would get alone, because
a CUDA session runs a short batch in a smaller bucket only where its probe
shows the bucket's outputs bitwise equal to a full batch's
(``InferenceSession.batch_size``), and a CPU session runs each conv on one
sample.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch


class _Work:
    __slots__ = ('tiles', 'kwargs', 'event', 'result', 'error')

    def __init__(self, tiles, kwargs):
        self.tiles = tiles
        self.kwargs = kwargs
        self.event = threading.Event()
        self.result = None
        self.error = None


class DispatchSession:
    """InferenceSession facade whose run_tiles coalesces concurrent callers.

    Drop-in for the ``session=`` argument of ``models.inference``: exposes
    opt / d / family / model_dir / max_batch / device and run_tiles.
    Thread-safe; every call of the wrapped session holds ``_device_lock``,
    and one dispatcher thread makes the coalesced calls.
    """

    def __init__(self, session):
        self._session = session
        self._q = queue.Queue()
        self._closed = False
        # serializes ALL wrapped-session calls: the dispatcher loop and the
        # bypass path below
        self._device_lock = threading.Lock()
        self.stats = {'device_calls': 0, 'coalesced_calls': 0,
                      'max_requests_per_call': 1}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- facade attributes read by models.inference()
    @property
    def opt(self):
        return self._session.opt

    @property
    def d(self):
        return self._session.d

    @property
    def family(self):
        return self._session.family

    @property
    def model_dir(self):
        return self._session.model_dir

    @property
    def max_batch(self):
        return self._session.max_batch

    @property
    def device(self):
        return self._session.device

    def _on_device(self):
        """The session's CUDA device as the calling thread's current device
        (a no-op context elsewhere)."""
        device = getattr(self._session, 'device', None)
        if device is not None and device.type == 'cuda':
            return torch.cuda.device(device)
        return contextlib.nullcontext()

    def run_tiles(self, tiles_u8, seg_weights=None, seg_only=False,
                  mod_only=False, return_intermediate=False, device_keys=()):
        if device_keys or return_intermediate:
            # device-kept outputs / intermediates: one device call per
            # request (device-kept outputs cannot be split after a
            # device-side stitch), still serialized against the dispatcher
            with self._device_lock, self._on_device():
                return self._session.run_tiles(
                    tiles_u8, seg_weights=seg_weights, seg_only=seg_only,
                    mod_only=mod_only, return_intermediate=return_intermediate,
                    device_keys=device_keys)
        kwargs = {
            'seg_weights': tuple(seg_weights) if seg_weights is not None else None,
            'seg_only': bool(seg_only),
            'mod_only': bool(mod_only),
        }
        if self._closed:
            raise RuntimeError('DispatchSession is closed')
        w = _Work(np.asarray(tiles_u8), kwargs)
        self._q.put(w)
        w.event.wait()
        if w.error is not None:
            raise w.error
        return w.result

    def _loop(self):
        # Every path out of this loop resolves each dequeued _Work: a
        # caller blocked on event.wait() has no timeout, so an escaped
        # exception (or the close sentinel) would otherwise hang every
        # in-flight and future request.
        #
        # Fairness: requests that cannot share the current device call are
        # held in ``pending`` (dispatcher-owned, arrival order preserved)
        # rather than re-queued at the back. Each cycle's group leader is
        # the OLDEST waiting request, so a client with an unusual config
        # (other seg_weights / tile shape) is served as soon as the device
        # frees up and is never leapfrogged by a stream of coalescable
        # traffic.
        pending = []
        closing = False
        with self._on_device():
            while True:
                if not pending:
                    if closing:
                        # the close sentinel was consumed inside the drain
                        # loop below; all work accepted before it is served
                        break
                    item = self._q.get()
                    if item is None:
                        break
                    pending.append(item)
                # drain everything else already queued, preserving order
                while not closing:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        closing = True
                    else:
                        pending.append(nxt)

                first = pending.pop(0)          # strict oldest-first leaders
                group = [first]
                try:
                    # the later arrivals that can share this device call:
                    # same flags and same tile shape, within max_batch
                    rest = []
                    total = len(first.tiles)
                    for w in pending:
                        same = (w.kwargs == first.kwargs
                                and w.tiles.shape[1:] == first.tiles.shape[1:])
                        if same and total + len(w.tiles) <= \
                                self._session.max_batch:
                            group.append(w)
                            total += len(w.tiles)
                        else:
                            rest.append(w)      # keeps its place in line
                    pending = rest

                    tiles = (first.tiles if len(group) == 1 else
                             np.concatenate([g.tiles for g in group]))
                    sw = first.kwargs['seg_weights']
                    with self._device_lock:
                        out = self._session.run_tiles(
                            tiles,
                            seg_weights=list(sw) if sw is not None else None,
                            seg_only=first.kwargs['seg_only'],
                            mod_only=first.kwargs['mod_only'])
                    self.stats['device_calls'] += 1
                    if len(group) > 1:
                        self.stats['coalesced_calls'] += 1
                        self.stats['max_requests_per_call'] = max(
                            self.stats['max_requests_per_call'], len(group))
                    pos = 0
                    for g in group:
                        n = len(g.tiles)
                        g.result = {k: v[pos:pos + n] for k, v in out.items()}
                        pos += n
                        g.event.set()
                except BaseException as e:  # noqa: BLE001 — to the callers
                    for g in group:
                        if not g.event.is_set():
                            g.error = e if isinstance(e, Exception) else \
                                RuntimeError(f'dispatcher died: {e!r}')
                            g.event.set()
                    if not isinstance(e, Exception):
                        raise
        # closed: fail anything still queued instead of leaving it blocked
        while True:
            try:
                w = self._q.get_nowait()
            except queue.Empty:
                return
            if w is not None:
                w.error = RuntimeError('DispatchSession is closed')
                w.event.set()

    def close(self):
        self._closed = True
        self._q.put(None)
