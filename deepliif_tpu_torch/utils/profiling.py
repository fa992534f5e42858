"""Profiling and device observability, the port's counterpart of
deepliif_tpu/utils/profiling.py on ``torch.cuda`` and ``torch.profiler``:

  * ``timeit``: a decorator that prints a call's seconds;
  * ``device_memory_stats`` / ``DeviceStatus``: bytes in use, peak and
    limit of a CUDA device (``torch.cuda.memory_stats``), and a 1 Hz
    sampler of them;
  * ``trace()``: a context manager around ``torch.profiler`` that yields a
    ``Trace``: the device's busy time and idle share over the block (or a
    window of it), and the host's waits on the device
    (``host_syncs``: stream, device and event synchronizations, blocking
    copies, and copies to pageable host memory, which block too).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import torch

# CUDA runtime calls on the host that wait for the device
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cudaMemcpy')
# the range ``trace`` wraps its block in
WINDOW = 'profiling.trace'

Event = collections.namedtuple('Event', 'name on_device start_us end_us')


def timeit(f):
    @functools.wraps(f)
    def wrap(*args, **kw):
        ts = time.time()
        result = f(*args, **kw)
        te = time.time()
        print(f'func:{f.__name__} took: {te - ts:2.4f} sec')
        return result
    return wrap


def device_memory_stats(device=None):
    """Bytes in use, peak and limit of a CUDA device (default: the current
    one); None values for a device that is not CUDA."""
    device = torch.device(device if device is not None else 'cuda')
    if device.type != 'cuda':
        return {'bytes_in_use': None, 'peak_bytes_in_use': None,
                'bytes_limit': None, 'device': str(device)}
    stats = torch.cuda.memory_stats(device)
    return {'bytes_in_use': stats.get('allocated_bytes.all.current'),
            'peak_bytes_in_use': stats.get('allocated_bytes.all.peak'),
            'bytes_limit': torch.cuda.get_device_properties(
                device).total_memory,
            'device': str(device)}


class DeviceStatus:
    """Background 1 Hz sampler of device memory (HardwareStatus analog)."""

    def __init__(self, interval=1.0, device=None):
        self.interval = interval
        self.device = device
        self.samples = []
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        def run():
            while not self._stop.is_set():
                try:
                    s = device_memory_stats(self.device)
                    s['t'] = time.time()
                    self.samples.append(s)
                except Exception:
                    pass
                self._stop.wait(self.interval)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        return self.samples

    def peak_bytes(self):
        vals = [s['peak_bytes_in_use'] for s in self.samples
                if s.get('peak_bytes_in_use')]
        return max(vals) if vals else None


class Trace:
    """The events of one traced block, in the profiler's microseconds.
    Each query takes an optional window (start_us, end_us); the default is
    the whole block."""

    def __init__(self, events):
        self.events = list(events)
        self.window = next(((e.start_us, e.end_us) for e in self.events
                            if e.name == WINDOW and not e.on_device), None)

    @classmethod
    def from_profile(cls, prof):
        dev = torch.autograd.DeviceType.CUDA
        return cls(Event(e.name, e.device_type == dev, e.time_range.start,
                         e.time_range.end) for e in prof.events())

    def _window(self, start, end):
        w0, w1 = self.window or (float('-inf'), float('inf'))
        return (w0 if start is None else start, w1 if end is None else end)

    def spans(self, name):
        """(start, end) of the host ranges named ``name``
        (``torch.profiler.record_function``), in order."""
        return sorted((e.start_us, e.end_us) for e in self.events
                      if e.name == name and not e.on_device)

    def device_events(self, start=None, end=None):
        a, b = self._window(start, end)
        return [e for e in self.events
                if e.on_device and e.end_us > a and e.start_us < b]

    def busy_ms(self, start=None, end=None):
        """The union of the device's kernels, copies and fills, clipped to
        the window."""
        a, b = self._window(start, end)
        busy, last = 0.0, a
        for s, e in sorted((max(e.start_us, a), min(e.end_us, b))
                           for e in self.device_events(a, b)):
            busy += max(0.0, e - max(s, last))
            last = max(last, e)
        return busy / 1e3

    def idle_share(self, start=None, end=None):
        """The share of the window in which the device ran nothing."""
        a, b = self._window(start, end)
        return 1.0 - self.busy_ms(a, b) * 1e3 / (b - a) if b > a else None

    def host_syncs(self, start=None, end=None):
        """{call: count} of the host's waits on the device that start in
        the window: the synchronizing runtime calls, and the copies to
        pageable host memory (counted by their device copy)."""
        a, b = self._window(start, end)
        out = collections.Counter()
        for e in self.events:
            if not a <= e.start_us < b:
                continue
            if not e.on_device and e.name in SYNC_CALLS:
                out[e.name] += 1
            elif e.on_device and 'Pageable' in e.name and 'DtoH' in e.name:
                out['Memcpy DtoH (Device -> Pageable)'] += 1
        return dict(out)

    def sync_sites(self, start=None, end=None, depth=3):
        """For each host wait (``host_syncs``' runtime calls) that starts
        in the window: the names of the ``depth`` innermost host ranges
        (torch ops, ``record_function`` ranges) that contain it."""
        a, b = self._window(start, end)
        host = [e for e in self.events if not e.on_device]
        out = []
        for e in host:
            if e.name in SYNC_CALLS and a <= e.start_us < b:
                around = sorted((h for h in host if h is not e
                                 and h.start_us <= e.start_us
                                 and e.end_us <= h.end_us),
                                key=lambda h: h.end_us - h.start_us)
                out.append([e.name] + [h.name for h in around[:depth]])
        return out


@contextlib.contextmanager
def trace(cuda=None, path=None):
    """Trace the block with ``torch.profiler`` (host activity, and the
    device's where ``cuda``, default: a CUDA device is present); yields
    a ``Trace`` that is filled when the block ends. Its window ends after
    a ``torch.cuda.synchronize()`` (one ``cudaDeviceSynchronize`` of its
    own), so that the device work the block launched lies inside it.
    ``path``: also write a Chrome trace there."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    result = Trace(())
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield result
            if cuda:
                torch.cuda.synchronize()
    result.__init__(Trace.from_profile(prof).events)
    if path:
        prof.export_chrome_trace(path)
