"""Tile-batch sweep of the PyTorch port (deepliif_tpu_torch) on one CUDA
card: tiles/s and peak device memory of ``InferenceSession.run_tiles`` (3
timed batches after one warm-up) for the flagship DeepLIIF ensemble
(4 x resnet_9blocks + 5 x unet_512, ngf 64, 512^2 tiles, random weights
from a seed, as chip_smoke.py writes them), per precision and batch. The port's default tile-batch cap
(``deepliif_tpu_torch.models.DEFAULT_MAX_BATCH``) is chosen from it.

    python3 experiments/torch_batch_sweep.py \\
        [--precisions float32,bfloat16,int8] [--batches 8,16,32,64]

Prints one JSON line per (precision, batch), then the card's name and power
limit. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--precisions', default='float32,bfloat16,int8')
    ap.add_argument('--batches', default='8,16,32,64')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the batch sweep needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.models import deepliif as dl

    M.configure_device(torch.device('cuda'))
    img = smoke.ihc_like_image(4 * smoke.TILE, smoke.SEED)
    rng = np.random.default_rng(smoke.SEED + 1)
    batches = [int(b) for b in args.batches.split(',')]
    origins = rng.integers(0, 3 * smoke.TILE + 1, (max(batches), 2))
    tiles = np.stack([img[y:y + smoke.TILE, x:x + smoke.TILE]
                      for y, x in origins])
    with tempfile.TemporaryDirectory() as md:
        smoke.write_flagship_model_dir(md, dl)
        for precision in args.precisions.split(','):
            for b in batches:
                session = M.InferenceSession(
                    md, max_batch=b, precision=precision,
                    int8_scope='resblocks' if precision == 'int8' else None)
                try:
                    res = smoke.throughput(session, tiles[:b])
                except torch.cuda.OutOfMemoryError as e:
                    res = {'batch': b, 'error': f'out of memory: {e}'[:200]}
                print(json.dumps({'precision': precision, **res}), flush=True)
                del session
                torch.cuda.empty_cache()
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
