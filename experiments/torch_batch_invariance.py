"""Whole-path batch invariance on one CUDA card, and what it costs.

1. Per op: the flagship nets (a resnet_9blocks translator and two unet_512
   seg nets, ngf 64, random weights from a seed, as chip_smoke.py writes
   them) run batches of 2, 4, 8 and 16 512^2 crops of a synthetic IHC
   image; every conv, conv-transpose, norm, plane_mean_var, stage kernel and
   trunk chain is called a second time on one tile's slice of the same
   inputs, and each op whose output for the tile differs alone vs in the
   batch is reported, for the port before the repair and as it is. The
   seg fusion (``tensordot``) is checked on its own.
2. Per conv call at batch 16: its time on the whole batch against one
   sample at a time (CUDA events), summed per net.
3. Per candidate: ``InferenceSession.run_tiles`` tiles/s at batch 16 and
   ms for one tile, and whether tile 3 alone gives the same uint8 outputs
   as in the batch, for
   - ``before``: power-of-two buckets, cuDNN on the whole bucket, torch's
     CUDA mean and variance for the norm statistics (the port before the
     repair);
   - ``per_sample``: power-of-two buckets, ``plane_mean_var``, every cuDNN
     call on one sample (16-byte aligned: cuDNN also picks by alignment);
   - ``one_batch_shape``: ``plane_mean_var``, every bucket padded to
     ``max_batch`` tiles, so cuDNN sees one shape, one cuDNN call per conv
     (the port before its probed buckets and per-sample bf16 convs). Its
     per-op check runs the tile alone so: first in a batch of 16
     otherwise zero;
   - ``probed``: the port as it is (``plane_mean_var``, power-of-two
     buckets where ``InferenceSession.probe_bucket`` holds them, each
     float32 cuDNN call that would differ padded to ``max_batch``, bf16
     convs one sample at a time).

    python3 experiments/torch_batch_invariance.py [--paths float32,bfloat16,int8,fused]
        [--before]     # the per-op report also for the 'before' ops

Prints one JSON line per (path, net) and per (path, candidate), then the
card's name and power limit. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402

TILE_IDX, BATCH = 3, 16
PATHS = {'float32': ('float32', False), 'bfloat16': ('bfloat16', False),
         'int8': ('int8', False), 'fused': ('bfloat16', True)}


def _tensors(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if isinstance(t, torch.Tensor)]


class Recorder:
    """While ``on``, each call of a watched function with a batch of
    ``self.batch`` is repeated on tile ``self.tile``'s slice of its inputs,
    and the two outputs for that tile are compared."""

    def __init__(self, padded):
        self.on, self.calls, self.differ = False, 0, []
        self.batch, self.tile, self.padded = BATCH, TILE_IDX, padded

    def _slice(self, v):
        if isinstance(v, torch.Tensor) and v.dim() and \
                v.shape[0] == self.batch:
            return self.alone(v, self.tile)
        return v

    def alone(self, v, tile):
        """Tile ``tile`` of batch ``v`` as the engine runs it alone."""
        one = v[tile:tile + 1]
        return torch.cat([one, torch.zeros_like(v[1:])]) if self.padded \
            else one

    def _wrap(self, fn, name):
        @functools.wraps(fn)             # keeps a wrapper's launch count
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if not (self.on and isinstance(a[0], torch.Tensor)
                    and a[0].shape[0] == self.batch):
                return out
            self.on = False              # no nested checks
            alone = fn(*[self._slice(v) for v in a],
                       **{kk: self._slice(v) for kk, v in k.items()})
            self.on = True
            self.calls += 1
            for got, ref in zip(_tensors(alone), _tensors(out)):
                if not torch.equal(got[0], ref[self.tile]):
                    d = (got[0].float() - ref[self.tile].float()).abs()
                    self.differ.append({
                        'op': name, 'shape': list(a[0].shape[1:]),
                        'max_abs_diff': d.max().item(),
                        'share_differing': (d > 0).float().mean().item()})
                    break
            return out
        return wrapped

    @contextlib.contextmanager
    def watching(self, targets):
        """targets: [(module, [function names])], wrapped for the block."""
        saved = [(owner, n, getattr(owner, n)) for owner, names in targets
                 for n in names]
        for owner, n, fn in saved:
            setattr(owner, n, self._wrap(fn, n))
        try:
            yield self
        finally:
            for owner, n, fn in saved:
                setattr(owner, n, fn)

    def run(self, net, xb, tile):
        """Per-op check over one batch forward, then the whole net's
        output for tile ``tile`` alone vs in the batch."""
        self.calls, self.differ = 0, []
        self.batch, self.tile = xb.shape[0], tile
        with torch.no_grad():
            self.on = True
            yb = net(xb)
            self.on = False
            ya = net(self.alone(xb, tile))
        return {'ops_checked': self.calls, 'ops_differing': self.differ,
                'output_equal': bool(torch.equal(yb[tile], ya[0]))}


def cuda_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def conv_costs(L):
    """Times every conv call of the block on the whole batch and one
    sample at a time; yields the list of (op, per-sample shape, batched ms,
    per-sample ms)."""
    costs, saved = [], L._per_sample

    def timed_call(fn, x, *args):
        costs.append((fn.__name__, list(x.shape[1:]),
                      cuda_ms(lambda: fn(x, *args)),
                      cuda_ms(lambda: per_sample(fn, x, *args))))
        return fn(x, *args)
    L._per_sample = timed_call
    try:
        yield costs
    finally:
        L._per_sample = saved


@contextlib.contextmanager
def candidate(name, M, L):
    """The port as it is (``one_batch_shape``), or patched into one of the
    other candidates."""
    saved = L._per_sample, L.plane_mean_var, M.InferenceSession.batch_size
    if name == 'one_batch_shape':
        M.InferenceSession.batch_size = lambda self, n, *a: self.max_batch
    elif name != 'probed':
        M.InferenceSession.batch_size = \
            lambda self, n, *a: M._bucket(n, self.max_batch)
    if name == 'before':
        L.plane_mean_var = L.plane_mean_var_reference
    if name == 'per_sample':
        L._per_sample = per_sample
    if name in ('before', 'one_batch_shape'):
        # one cuDNN call per conv at any dtype (the port before its
        # per-sample bf16 convs)
        L._per_sample = lambda fn, x, *args: fn(x, *args)
    try:
        yield
    finally:
        L._per_sample, L.plane_mean_var, M.InferenceSession.batch_size = saved


def _aligned(x):
    # cuDNN also picks its algorithm by the alignment of the data: a bf16
    # sample of the padded 3-channel head input starts 8 bytes off for odd
    # tiles
    return x if x.data_ptr() % 16 == 0 else x.clone()


def per_sample(fn, x, *args):
    """``fn(x, *args)`` one sample at a time, each 16-byte aligned."""
    if x.shape[0] == 1:
        return fn(_aligned(x), *args)
    return torch.cat([fn(_aligned(x[i:i + 1]), *args)
                      for i in range(x.shape[0])])


def timed(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--paths', default='float32,bfloat16,int8,fused')
    ap.add_argument('--before', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the batch-invariance probe needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.labs import fused_stages as FS
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L
    from deepliif_tpu_torch.ops import fused_resblock as FR

    targets = [(L, ('conv2d', 'conv_transpose2d', 'batch_stat_norm',
                    'plane_mean_var')),
               (FR, ('resblock_chain', 'resblock_chain_int8')),
               (FS, ('conv3x3_s2_stats', 'convtranspose3_s2_stats'))]
    img = smoke.ihc_like_image(2 * smoke.TILE, smoke.SEED)
    origins = np.random.default_rng(smoke.SEED + 1).integers(
        0, smoke.TILE + 1, (BATCH, 2))
    tiles = np.stack([img[y:y + smoke.TILE, x:x + smoke.TILE]
                      for y, x in origins])
    with tempfile.TemporaryDirectory() as md:
        smoke.write_flagship_model_dir(md, dl)
        for path in args.paths.split(','):
            precision, fused = PATHS[path]
            sess = M.InferenceSession(
                md, device='cuda', precision=precision, max_batch=BATCH,
                int8_scope='resblocks' if precision == 'int8' else None,
                fuse_stages=fused)
            xb = (torch.from_numpy(tiles).cuda().float() / 127.5 - 1.0
                  ).permute(0, 3, 1, 2).to(sess.d.dtype)
            nets = (('translator G1', sess.nets.G[0]),
                    ('seg GS1', sess.nets.GS[0]), ('seg GS2', sess.nets.GS[1]))
            for cand in (('before', 'per_sample', 'one_batch_shape')
                         if args.before else ('one_batch_shape',)):
                with candidate(cand, M, L), Recorder(
                        cand == 'one_batch_shape').watching(targets) as rec:
                    for name, net in nets:
                        by_batch = {}
                        for b in (2, 4, 8, BATCH):
                            r = rec.run(net, xb[:b], min(TILE_IDX, b - 1))
                            by_batch[b] = {
                                'ops_checked': r['ops_checked'],
                                'output_equal': r['output_equal'],
                                'ops_differing': sorted({
                                    f"{d['op']} {d['shape']}"
                                    for d in r['ops_differing']})}
                            if b == BATCH:
                                by_batch['detail_16'] = r['ops_differing']
                        print(json.dumps({'path': path, 'candidate': cand,
                                          'net': name, **by_batch}),
                              flush=True)
            with candidate('before', M, L), torch.no_grad():
                for name, net in nets:
                    with conv_costs(L) as costs:
                        net(xb)
                    worst = sorted(costs, key=lambda c: c[2] - c[3])[:6]
                    print(json.dumps({
                        'path': path, 'net': name, 'conv_calls': len(costs),
                        'batched_ms': sum(c[2] for c in costs),
                        'per_sample_ms': sum(c[3] for c in costs),
                        'costliest_per_sample': worst}), flush=True)
            segs = torch.randn((5, BATCH, smoke.TILE, smoke.TILE, 3)).cuda(
                ).to(sess.d.dtype)
            wts = torch.tensor(sess.d.seg_weights, device=segs.device).to(
                sess.d.dtype)
            fusion = torch.tensordot(wts, segs, dims=1)
            alone = torch.tensordot(
                wts, segs[:, TILE_IDX:TILE_IDX + 1].contiguous(), dims=1)
            print(json.dumps({'path': path, 'op': 'seg fusion tensordot',
                              'output_equal': bool(torch.equal(
                                  fusion[TILE_IDX], alone[0]))}), flush=True)

            for cand in ('before', 'per_sample', 'one_batch_shape',
                         'probed'):
                with candidate(cand, M, L):
                    full = sess.run_tiles(tiles)
                    one = sess.run_tiles(tiles[TILE_IDX:TILE_IDX + 1])
                    holds = all(np.array_equal(full[k][TILE_IDX], one[k][0])
                                for k in full)
                    batch_s = timed(lambda: sess.run_tiles(tiles))
                    one_s = timed(lambda: sess.run_tiles(
                        tiles[TILE_IDX:TILE_IDX + 1]))
                print(json.dumps({
                    'path': path, 'candidate': cand, 'holds': holds,
                    'tiles_per_s_batch16': BATCH / batch_s,
                    'one_tile_ms': one_s * 1e3}), flush=True)
            del sess, xb, segs
            torch.cuda.empty_cache()
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
