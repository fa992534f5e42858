"""Data layer of training: the dataset factory and a batching loader with
background prefetch, the port's own copy of deepliif_tpu/data/__init__.py.

Replaces the reference CustomDatasetDataLoader / torch DataLoader /
DistributedSampler stack (reference deepliif/data/__init__.py:58-131) with
a thread-prefetched numpy loader, seeded as the JAX package's is, so both
packages give the same batches for one seed. One process: the rank and
world size are the options' (``rank`` / ``world_size``), default 0 of 1.
"""

from __future__ import annotations

import queue
import random
import threading

import numpy as np

from .aligned import AlignedDataset, SingleDataset, UnalignedDataset
from .transforms import apply_transform, get_params  # noqa: F401


def create_dataset(opt, phase='train'):
    """The loader of ``opt.dataset_mode``: 'single' (``SingleDataset``),
    'unaligned' or any mode of a CycleGAN model (``UnalignedDataset``),
    else 'aligned' (``AlignedDataset``), as the JAX package picks it."""
    mode = getattr(opt, 'dataset_mode', 'aligned')
    if mode == 'single':
        ds = SingleDataset(opt, phase)
    elif getattr(opt, 'model', '') == 'CycleGAN' or mode == 'unaligned':
        ds = UnalignedDataset(opt, phase)
    else:
        ds = AlignedDataset(opt, phase)
    return Loader(
        ds,
        batch_size=getattr(opt, 'batch_size', 1),
        shuffle=(phase == 'train') and not getattr(opt, 'serial_batches', False),
        seed=getattr(opt, 'seed', None),
        rank=getattr(opt, 'rank', None) or 0,
        world_size=getattr(opt, 'world_size', None) or 1,
        num_workers=getattr(opt, 'num_threads', 2),
        max_dataset_size=getattr(opt, 'max_dataset_size', None),
    )


def _collate(samples):
    """Stack samples into a batch. 'B_mods'/'B_segs' get shape (M,B,H,W,C);
    everything else (B,...)."""
    out = {}
    for k in samples[0]:
        if k.endswith('_paths'):
            out[k] = [s[k] for s in samples]
        elif k in ('B_mods', 'B_segs'):
            out[k] = np.stack([s[k] for s in samples], axis=1)
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class Loader:
    """Epoch-based iterable over batches with thread prefetch.

    ``num_workers`` sizes the prefetch QUEUE (batches decoded ahead), not
    a decode pool: get_params draws from the seeded global RNG, so a
    single decode thread is what keeps `--seed` runs deterministic (the
    reference gets the same property from seeded DataLoader workers)."""

    def __init__(self, dataset, batch_size=1, shuffle=True, seed=None,
                 rank=0, world_size=1, num_workers=2, max_dataset_size=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        self.prefetch = max(1, num_workers)
        self.max_dataset_size = max_dataset_size

    def __len__(self):
        n = len(self.dataset)
        if self.max_dataset_size:
            n = min(n, self.max_dataset_size)
        return n

    def set_epoch(self, epoch):
        """Reshuffle differently each epoch (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            rng = random.Random((self.seed or 0) * 100003 + self.epoch)
            rng.shuffle(idx)
        idx = idx[self.rank::self.world_size]
        if self.max_dataset_size:
            idx = idx[:self.max_dataset_size]
        return idx

    def __iter__(self):
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        # pad the final partial batch to batch_size by repeating its own
        # samples (the DistributedSampler convention): every step has the
        # batch's shape, and the batch-coupled norm always sees batch_size
        # samples, as in the JAX package
        if batches and self.batch_size > 1 \
                and len(batches[-1]) < self.batch_size:
            last = batches[-1]
            batches[-1] = (last * self.batch_size)[:self.batch_size]
        q = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()

        def worker():
            try:
                for b in batches:
                    item = _collate([self.dataset[i] for i in b])
                    while not cancel.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if cancel.is_set():
                        return
                q.put(stop)
            except BaseException as e:  # propagate, never truncate silently
                q.put(('error', e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == 'error':
                    raise RuntimeError(
                        f'data loading failed: {item[1]!r}') from item[1]
                yield item
        finally:
            # early exit (--debug break, exception): unblock and stop the
            # producer so it cannot leak a thread holding queued batches
            cancel.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
