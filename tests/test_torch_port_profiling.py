"""The port's profiling helpers (``utils.profiling``) on the CPU: the
decorator, the memory sampler off a CUDA device, a real trace of host
ranges, and the device-side queries (busy time, idle share, host waits
and the ranges around them) on a synthetic event list."""

import numpy as np
import torch

from deepliif_tpu_torch.utils import profiling as P


def test_timeit_prints_and_returns(capsys):
    @P.timeit
    def add(a, b):
        return a + b
    assert add(2, 3) == 5
    assert 'func:add took:' in capsys.readouterr().out


def test_memory_stats_and_sampler_off_cuda():
    stats = P.device_memory_stats('cpu')
    assert stats == {'bytes_in_use': None, 'peak_bytes_in_use': None,
                     'bytes_limit': None, 'device': 'cpu'}
    status = P.DeviceStatus(interval=0.01, device='cpu').start()
    samples = status.stop()
    assert samples and all('t' in s for s in samples)
    assert status.peak_bytes() is None


def test_trace_records_the_block_and_its_ranges():
    from torch.profiler import record_function
    with P.trace(cuda=False) as tr:
        for _ in range(2):
            with record_function('batch'):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert tr.window is not None and tr.window[1] > tr.window[0]
    spans = tr.spans('batch')
    assert len(spans) == 2 and spans[0][1] <= spans[1][0]
    assert all(tr.window[0] <= a and b <= tr.window[1] for a, b in spans)
    assert tr.device_events() == [] and tr.host_syncs() == {}
    assert tr.busy_ms() == 0.0 and tr.idle_share() == 1.0


def test_device_queries_on_synthetic_events():
    E = P.Event
    tr = P.Trace([
        E(P.WINDOW, False, 0, 100),
        E('kernel_a', True, 10, 30), E('kernel_b', True, 20, 40),
        E('Memcpy DtoH (Device -> Pinned)', True, 50, 60),
        E('Memcpy DtoH (Device -> Pageable)', True, 70, 80),
        E('cudaStreamSynchronize', False, 45, 46),
        E('cudaEventSynchronize', False, 61, 62),
        E('cudaLaunchKernel', False, 5, 6),
        E('kernel_a', True, 95, 110)])
    # busy: [10, 40] + [50, 60] + [70, 80] + [95, 100] clipped
    assert np.isclose(tr.busy_ms(), 0.055)
    assert np.isclose(tr.idle_share(), 1 - 55 / 100)
    assert tr.host_syncs() == {'cudaStreamSynchronize': 1,
                               'cudaEventSynchronize': 1,
                               'Memcpy DtoH (Device -> Pageable)': 1}
    assert tr.host_syncs(0, 50) == {'cudaStreamSynchronize': 1}
    assert np.isclose(tr.busy_ms(0, 25), 0.015)
    assert np.isclose(tr.idle_share(40, 50), 1.0)
    assert tr.sync_sites() == [['cudaStreamSynchronize', P.WINDOW],
                               ['cudaEventSynchronize', P.WINDOW]]
