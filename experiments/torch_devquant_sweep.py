"""Device vs host quantifier of the PyTorch port (deepliif_tpu_torch) on one
CUDA card, by canvas size: the measurements behind the ``device_quant='auto'``
rule in ``deepliif_tpu_torch/models/__init__.py``.

For each canvas (chip_smoke.py's synthetic seg canvas: IHC-like nuclei, one
per 40 x 40 px, with a marker) it times the device quantifier
(``ops.labeling.compute_final_results_device`` on the canvas already on the
card, results fetched) and the host quantifier
(``postprocessing.compute_final_results``), each the median of 3 runs after
a warm-up run, checks that their counts agree, and reads the device
quantifier's peak memory per pixel. Then it probes the device->host copy
bandwidth (4 MiB and 256 MiB copies) and the peak memory of a batch-16
float32 flagship session, and derives:

  crossover: the smallest canvas from which the device path wins at it and
             at every larger canvas measured (the smallest canvas measured
             where it wins everywhere: nothing below it was measured);
  D2H bar:   the copy bandwidth at which fetching the two result canvases
             (overlay, refined: 6 B/px) would eat the device path's gain,
             the highest over the canvases from the crossover up;
  cap:       the largest canvas that fits the card beside a batch-16
             session (the quantifier's peak memory as a line in the pixel
             count through the two largest canvases, plus 7 B/px for the
             stitched seg canvas and the seg tiles it is gathered from),
             and below the 2^31 pixels of the kernel's int32 indices.

    python3 experiments/torch_devquant_sweep.py [--canvases 128x128,256x256,
        512x512,1024x1024,1536x1280,2048x2048,4096x4096,8192x8192]

Prints one JSON line per canvas, the probes, the derived numbers, then the
card's name and power limit. Imports nothing of jax or deepliif_tpu. Where a
canvas has more than 16384 cells the counts may differ from the host's: the
device KDE keeps the 16384 largest cells (as the JAX package does), which
can move the default size threshold.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402

RESULT_BYTES_PER_PX = 6      # overlay + refined, uint8 RGB each
CANVAS_BYTES_PER_PX = 7      # the seg canvas (3) and the seg tiles (~4)


def median_seconds(fn, runs=3):
    """Median wall time of ``fn`` over ``runs`` calls after a warm-up
    call, the times of those calls, and the last call's result."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times, out


def d2h_mbps(nbytes):
    """Device->host copy rate (MB/s) of an ``nbytes`` uint8 tensor, after
    a warm-up copy."""
    x = torch.ones(nbytes, dtype=torch.uint8, device='cuda')
    x.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x.cpu()
    return nbytes / 1e6 / (time.perf_counter() - t0)


def session_peak_bytes(M, dl):
    """Peak device memory of a batch-16 float32 flagship session over one
    run_tiles of 16 tiles."""
    img = smoke.ihc_like_image(2 * smoke.TILE, smoke.SEED)
    rng = np.random.default_rng(smoke.SEED + 1)
    origins = rng.integers(0, smoke.TILE + 1, (smoke.BATCH, 2))
    tiles = np.stack([img[y:y + smoke.TILE, x:x + smoke.TILE]
                      for y, x in origins])
    with tempfile.TemporaryDirectory() as md:
        smoke.write_flagship_model_dir(md, dl)
        session = M.InferenceSession(md, max_batch=smoke.BATCH,
                                     precision='float32')
        res = smoke.throughput(session, tiles, iters=1)
        del session
    torch.cuda.empty_cache()
    return res['peak_mem_bytes']


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--canvases', default='128x128,256x256,512x512,'
                                          '1024x1024,1536x1280,2048x2048,'
                                          '4096x4096,8192x8192')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the quantifier sweep needs a CUDA card')
    from deepliif_tpu_torch import models as M, postprocessing as pp
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.ops import labeling as LB

    M.configure_device(torch.device('cuda'))
    kw = dict(size_thresh='default', marker_thresh='default')
    rows = []
    for i, hw in enumerate(tuple(map(int, c.split('x')))
                           for c in args.canvases.split(',')):
        h, w = hw
        orig, seg, marker = smoke.synthetic_seg_canvas(h, w, smoke.SEED + i)
        orig_np, seg_np, marker_np = (t.cpu().numpy()
                                      for t in (orig, seg, marker))
        del orig, marker
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dev_s, runs, dev = median_seconds(
            lambda: LB.compute_final_results_device(orig_np, seg, marker_np,
                                                    '40x', **kw))
        peak = torch.cuda.max_memory_allocated() - base
        host_s, host_runs, host = median_seconds(
            lambda: pp.compute_final_results(orig_np, seg_np, marker_np,
                                             '40x', **kw))
        row = {'canvas': [h, w], 'mpx': h * w / 1e6,
               'cells': dev[2]['num_total'],
               'device_s': dev_s, 'device_runs_s': runs,
               'host_s': host_s, 'host_runs_s': host_runs,
               'peak_bytes': peak,
               'peak_bytes_per_px': peak / (h * w),
               'counts_equal': all(dev[2][k] == host[2][k] for k in
                                   ('num_total', 'num_pos', 'num_neg')),
               'device_scoring': dev[2], 'host_scoring': host[2]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del seg, dev, host
        torch.cuda.empty_cache()

    probe_mbps = d2h_mbps(4 * 2 ** 20)
    big_mbps = d2h_mbps(256 * 2 ** 20)
    sess_peak = session_peak_bytes(M, dl)
    total = torch.cuda.get_device_properties(0).total_memory
    print(json.dumps({'d2h_probe_mbps': probe_mbps,
                      'd2h_256mib_mbps': big_mbps,
                      'session_peak_bytes': sess_peak,
                      'card_total_bytes': total}), flush=True)

    wins = [r['device_s'] < r['host_s'] for r in rows]
    first = next((i for i in range(len(rows)) if all(wins[i:])), None)
    bar = None
    if first is not None:
        # the bandwidth at which the result fetch (measured inside
        # device_s at the probed rate) would grow by the whole gain
        bar = max(RESULT_BYTES_PER_PX * r['mpx']
                  / (RESULT_BYTES_PER_PX * r['mpx'] / probe_mbps
                     + r['host_s'] - r['device_s'])
                  for r in rows[first:])
    # peak memory = fixed + per_px * pixels, through the two largest
    a, b = sorted(rows, key=lambda r: r['mpx'])[-2:]
    per_px = (b['peak_bytes'] - a['peak_bytes']) / ((b['mpx'] - a['mpx']) * 1e6)
    fixed = b['peak_bytes'] - per_px * b['mpx'] * 1e6
    cap = min(int((total - sess_peak - max(fixed, 0.0))
                  / (per_px + CANVAS_BYTES_PER_PX)), 2 ** 31 - 1)
    print(json.dumps({
        'crossover_px': rows[first]['mpx'] * 1e6 if first is not None
        else None,
        'device_wins_at_every_canvas': all(wins),
        'd2h_bar_mbps': bar, 'cap_px': cap,
        'cap_limited_by': 'memory' if cap < 2 ** 31 - 1 else 'int32 index',
        'quantifier_peak_bytes_per_px': per_px,
        'quantifier_peak_fixed_bytes': fixed,
        'counts_equal': {f'{r["canvas"][0]}x{r["canvas"][1]}':
                         r['counts_equal'] for r in rows}}),
        flush=True)
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
