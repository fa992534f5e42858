"""Does a tile's output depend on its position in a batch, on one CUDA
card? For each flagship path (4 x resnet_9blocks + 5 x unet_512, ngf 64,
random weights from a seed as chip_smoke.py writes them) 40 crops of a
synthetic IHC image, four of them empty, through ``run_tiles`` three
ways: all 40 in one call with one batch shape (every batch padded to 16,
no bucket), the same 16 at a time in separate calls (other positions),
and one at a time; each output's tiles that differ from the first way,
with their positions in its batches. ``--before`` runs bf16 convs as one
batched cuDNN call (the port before its per-sample bf16 convs).

    python3 experiments/torch_batch_positions.py [--paths float32,bfloat16,int8,fused] [--before]

Prints one JSON line per path, then the card's name and power limit.
Imports nothing of jax or deepliif_tpu.
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

PATHS = {'float32': dict(precision='float32'),
         'bfloat16': dict(precision='bfloat16'),
         'int8': dict(precision='int8', int8_scope='resblocks'),
         'fused': dict(precision='bfloat16', fuse_stages=True)}


def batched(fn, x, *args):
    """The parent's ``layers._per_sample`` on CUDA: one call."""
    return fn(x, *args)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--paths', default=','.join(PATHS))
    ap.add_argument('--before', action='store_true')
    args = ap.parse_args()
    from PIL import Image
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L
    M.configure_device(torch.device('cuda'))
    if args.before:
        L._per_sample = batched
    img = Image.fromarray(smoke.ihc_like_image(2 * smoke.TILE, smoke.SEED))
    tiles = smoke.pipeline_tiles(img)
    nonempty = [i for i in range(len(tiles)) if i not in smoke.PIPE_EMPTY]
    with tempfile.TemporaryDirectory() as md:
        smoke.write_flagship_model_dir(md, dl)
        for name in args.paths.split(','):
            s = M.InferenceSession(md, device='cuda', max_batch=smoke.BATCH,
                                   **PATHS[name])
            one_shape = s.batch_size
            s.batch_size = lambda n, *a: s.max_batch
            ref = s.run_tiles(tiles)
            s.batch_size = one_shape
            ways = {'separate_calls_of_16': [
                        s.run_tiles(tiles[i:i + smoke.BATCH])
                        for i in range(0, len(tiles), smoke.BATCH)],
                    'one_at_a_time': [s.run_tiles(tiles[i:i + 1])
                                      for i in range(len(tiles))]}
            out = {'path': name, 'before': args.before,
                   'position_in_ref_batch': {
                       int(t): nonempty.index(t) % smoke.BATCH
                       for t in nonempty}}
            for way, parts in ways.items():
                got = {k: np.concatenate([p[k] for p in parts]) for k in ref}
                out[way] = {k: [int(i) for i in np.where(
                    (got[k] != ref[k]).reshape(len(tiles), -1).any(1))[0]]
                    for k in ref}
            print(json.dumps(out), flush=True)
            del s
            torch.cuda.empty_cache()
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
