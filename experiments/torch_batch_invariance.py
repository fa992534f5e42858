"""Which layer makes a tile's result depend on the batch it rides in, on one
CUDA card: the flagship nets (a resnet_9blocks translator and two unet_512
seg nets, ngf 64, random weights from a seed, as chip_smoke.py writes them)
run a batch of 16 random 512^2 tiles and then tile 3 alone; every conv,
conv-transpose, pad, norm and trunk chain records its output for tile 3,
and the first op whose output differs between the two runs is reported,
with the largest difference and the share of elements that differ. The
seg fusion (``tensordot`` over the branch outputs) is checked on its own.

    python3 experiments/torch_batch_invariance.py [--precisions float32,bfloat16]

Prints one JSON line per (precision, net), then the card's name and power
limit. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402

TILE_IDX, BATCH = 3, 16


class Recorder:
    """Wraps functions so that each call's output for the watched tile is
    kept (first run) or compared with the kept one (second run)."""

    def __init__(self):
        self.mode, self.log, self.pos, self.first = None, [], 0, None

    def wrap(self, owner, name):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if self.mode == 'batch':
                self.log.append((name, list(out.shape), out[TILE_IDX].clone()))
            elif self.mode == 'alone':
                op, shape, ref = self.log[self.pos]
                if self.first is None and not torch.equal(ref, out[0]):
                    d = (ref.float() - out[0].float()).abs()
                    self.first = {'op_index': self.pos, 'op': op,
                                  'batch_shape': shape,
                                  'max_abs_diff': d.max().item(),
                                  'share_differing': (d > 0).float().mean().item()}
                self.pos += 1
            return out
        setattr(owner, name, wrapped)

    def run(self, net, xb):
        self.mode, self.log, self.pos, self.first = 'batch', [], 0, None
        yb = net(xb)
        self.mode = 'alone'
        ya = net(xb[TILE_IDX:TILE_IDX + 1])
        self.mode = None
        return bool(torch.equal(yb[TILE_IDX], ya[0])), len(self.log), self.first


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--precisions', default='float32,bfloat16')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the batch-invariance probe needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.ops import fused_resblock as FR
    from deepliif_tpu_torch.utils import checkpoints as ck

    rec = Recorder()
    for name in ('conv2d', 'conv_transpose2d', 'batch_stat_norm', 'pad2d'):
        rec.wrap(L, name)
    for name in ('resblock_chain', 'resblock_chain_int8'):
        rec.wrap(FR, name)
    with tempfile.TemporaryDirectory() as md:
        smoke.write_flagship_model_dir(md, dl, ck)
        for precision in args.precisions.split(','):
            scope = 'resblocks' if precision == 'int8' else None
            sess = M.InferenceSession(md, device='cuda', precision=precision,
                                      int8_scope=scope, max_batch=BATCH)
            gen = torch.Generator().manual_seed(smoke.SEED + 1)
            xb = (torch.rand((BATCH, 3, smoke.TILE, smoke.TILE), generator=gen)
                  * 2 - 1).cuda().to(sess.d.dtype)
            nets = [('translator G1', sess.nets.G[0]),
                    ('seg GS1', sess.nets.GS[0]), ('seg GS2', sess.nets.GS[1])]
            with torch.no_grad():
                for name, net in nets:
                    equal, n_ops, first = rec.run(net, xb)
                    print(json.dumps({'precision': precision, 'net': name,
                                      'ops_watched': n_ops,
                                      'output_equal': equal,
                                      'first_differing_op': first}),
                          flush=True)
                segs = torch.randn((5, BATCH, smoke.TILE, smoke.TILE, 3),
                                   generator=gen).cuda().to(sess.d.dtype)
                wts = torch.tensor(sess.d.seg_weights,
                                   device='cuda').to(sess.d.dtype)
                fused = torch.tensordot(wts, segs, dims=1)
                alone = torch.tensordot(
                    wts, segs[:, TILE_IDX:TILE_IDX + 1].contiguous(), dims=1)
                print(json.dumps({'precision': precision,
                                  'op': 'seg fusion tensordot',
                                  'output_equal': bool(torch.equal(
                                      fused[TILE_IDX], alone[0]))}),
                      flush=True)
            del sess
            torch.cuda.empty_cache()
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
