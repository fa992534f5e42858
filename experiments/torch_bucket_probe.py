"""Which power-of-two buckets hold batch invariance on one CUDA card, and
what a short batch costs in each.

For each flagship path (4 x resnet_9blocks + 5 x unet_512, ngf 64, random
weights from a seed as chip_smoke.py writes them, 512^2 tiles) the
session's own bucket probes (``InferenceSession.probe_bucket``: random
tiles at ``max_batch`` and their first b in a forward of b, each cuDNN
call whose bits differ from the full batch's padded to it, every output
bitwise against the full batch's) at ``max_batch`` 16 (and 18, the
server's), with each probe's seconds and padded calls; then
``--timing``: one tile's forward padded to each bucket (1, 2, 4, 8, 16)
with that bucket's padded calls, host wall ms (mean of 3 after a
warm-up), whatever the probe said.

    python3 experiments/torch_bucket_probe.py [--paths float32,bfloat16,int8,fused,int8_all]
        [--max-batch 16,18] [--timing]

Prints one JSON line per (path, max_batch), then the card's name and power
limit. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402

# path -> (precision, fuse_stages, int8_scope, int8_calibrate)
PATHS = {'float32': ('float32', False, None, True),
         'bfloat16': ('bfloat16', False, None, True),
         'int8': ('int8', False, 'resblocks', True),
         'fused': ('bfloat16', True, None, True),
         'int8_all': ('int8', False, 'all', False)}
FORWARD = dict(seg_weights=None, mod_only=False, seg_only=False,
               return_intermediate=False, marker_index=None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--paths', default=','.join(PATHS))
    ap.add_argument('--max-batch', default='16,18')
    ap.add_argument('--timing', action='store_true')
    args = ap.parse_args()
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L
    tile = np.asarray(smoke.ihc_like_image(smoke.TILE, smoke.SEED))[None]
    with tempfile.TemporaryDirectory() as md:
        smoke.write_flagship_model_dir(md, dl)
        for name in args.paths.split(','):
            precision, fused, scope, calibrate = PATHS[name]
            for mb in (int(v) for v in args.max_batch.split(',')):
                s = M.InferenceSession(md, device='cuda', max_batch=mb,
                                       precision=precision,
                                       fuse_stages=fused, int8_scope=scope,
                                       int8_calibrate=calibrate)
                s.build_kernels()
                t0 = time.perf_counter()
                probes = {b: s.probe_bucket(tile.shape[1:], FORWARD, b)
                          for b in (1, 2, 4, 8, 16) if b < mb}
                out = {'path': name, 'max_batch': mb,
                       'probe_seconds': time.perf_counter() - t0,
                       'probes': {b: {
                           'holds': p['holds'], 'differs': p['differs'],
                           'seconds': p['seconds'],
                           'padded': smoke.padded_calls(p['padded'])}
                           for b, p in probes.items()},
                       'lone_tile_batch': s.batch_size(
                           1, tile.shape[1:], FORWARD)}
                if args.timing and mb == 16:
                    ms = {}
                    for b in (1, 2, 4, 8, 16):
                        x = torch.from_numpy(np.concatenate(
                            [tile, np.zeros((b - 1,) + tile.shape[1:],
                                            np.uint8)]))
                        hook = s._bucket_hook(tile.shape[1:], FORWARD, b)
                        with L.cudnn_hook(hook):
                            s.forward(x)['mods'].cpu()
                            t0 = time.perf_counter()
                            for _ in range(3):
                                s.forward(x)['mods'].cpu()
                        ms[b] = (time.perf_counter() - t0) / 3 * 1e3
                    out['one_tile_forward_ms_by_bucket'] = ms
                print(json.dumps(out), flush=True)
                del s
                torch.cuda.empty_cache()
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
