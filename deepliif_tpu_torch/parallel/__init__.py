"""Several cards: replicas for tile inference, data parallelism for training.

Port of deepliif_tpu/parallel/__init__.py. The JAX package runs one
program over a mesh of all devices with the batch sharded on a 'data' axis:
``make_sharded_forward`` (inference, parameters replicated) and
``make_data_parallel_train_step`` (training; XLA emits the gradient
all-reduce and, for the train-mode batch norm, the statistics over the
global batch). In PyTorch the same splits are written out:

- inference (``models.InferenceSession``): one replica of the nets per
  card, each bucket cut into contiguous per-card shards (``shard_bounds``),
  one host thread per card;
- training: one process per card in a ``torch.distributed`` group
  (``init_process_group``: NCCL on cards, gloo on the CPU), each rank on
  the contiguous shard ``rank`` of the global batch (``shard_batch``);
  inside ``data_parallel(dp)`` the train-mode batch norm takes its
  statistics over the global batch (``gather_rows``, autograd-aware),
  dropout keeps this rank's rows of the global batch's mask
  (``global_rows``), and ``all_reduce_grads`` averages the gradients
  over ranks before each optimizer update. Every cross-rank sum is taken
  in rank order on every rank (a gather, then a local sum), so the ranks
  hold bitwise equal results and two runs are bitwise equal.

Not ported yet: ``spatial_halo_apply`` (the mesh-sharded labeling; ROADMAP.md,
"Serving").
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os

import torch

from .. import roadmap

# the torchrun environment of a process group
TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')

# elements per collective of ``all_reduce_grads`` (the gathered copies of
# one chunk are world x this many values)
GRAD_CHUNK = 1 << 26


def get_devices(device='cuda', n=None, devices=None):
    """The devices of a session or a step, the counterpart of the JAX
    ``get_mesh(n_devices, devices=)``: ``devices`` as given (a device may
    appear twice: two replicas on one card), else every visible card for
    ``device`` 'cuda' (one entry, cuda:0, where none is visible, so that
    the first use fails rather than run on the CPU), else ``device``
    alone; the first ``n`` of them (at least one)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError('devices= names no device')
    else:
        dev = torch.device(device)
        if dev.type == 'cuda' and dev.index is None:
            devs = [torch.device('cuda', i)
                    for i in range(max(1, torch.cuda.device_count()))]
        else:
            devs = [dev]
    if n is not None:
        devs = devs[:max(1, int(n))]
    return devs


def pad_to_multiple(n, m):
    return ((n + m - 1) // m) * m


def shard_bounds(n, parts):
    """[(start, stop)] of the ``parts`` contiguous equal shards of ``n``
    rows (the JAX P('data') split); ``n`` must divide by ``parts``."""
    if n % parts:
        raise ValueError(f'{n} rows do not split into {parts} equal shards')
    k = n // parts
    return [(i * k, (i + 1) * k) for i in range(parts)]


def batch_axis(key):
    """The batch axis of a training batch's entry: 1 for the stacked
    modalities ('B_mods' (M, B, ...), 'B_segs'), else 0."""
    return 1 if key in ('B_mods', 'B_segs') else 0


def shard_batch(batch, rank, world):
    """This rank's contiguous shard of every entry of a global batch (a
    dict of arrays or tensors; '*_paths' lists too)."""
    out = {}
    for k, v in batch.items():
        ax = 0 if k.endswith('_paths') else batch_axis(k)
        start, stop = shard_bounds(len(v) if ax == 0 else v.shape[ax],
                                   world)[rank]
        if k.endswith('_paths'):
            out[k] = list(v[start:stop])
        elif ax == 0:
            out[k] = v[start:stop]
        else:
            out[k] = v[:, start:stop]
    return out


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """A rank of a data-parallel step: ``rank`` of ``world`` in the
    default process group; ``local_rank`` of ``local_world`` on its node
    (``node`` of ``nodes``)."""
    rank: int
    world: int
    local_rank: int = 0
    local_world: int = 1

    @property
    def node(self):
        return self.rank // self.local_world

    @property
    def nodes(self):
        return self.world // self.local_world


_DP = contextvars.ContextVar('data_parallel', default=None)


@contextlib.contextmanager
def data_parallel(dp):
    """In the block (this thread), the train-mode norms, dropout and
    ``all_reduce_grads`` act over the ranks of ``dp`` (a ``DataParallel``;
    None, or a world of one: as on one device)."""
    token = _DP.set(dp if dp is not None and dp.world > 1 else None)
    try:
        yield
    finally:
        _DP.reset(token)


def current():
    """The ``DataParallel`` of the enclosing ``data_parallel`` block, or
    None."""
    return _DP.get()


def torchrun_env(environ=None):
    """(rank, world, local_rank, local_world) from a torchrun environment,
    or None where it is incomplete."""
    env = os.environ if environ is None else environ
    if not all(k in env for k in TORCHRUN_ENV):
        return None
    world = int(env['WORLD_SIZE'])
    return (int(env['RANK']), world, int(env['LOCAL_RANK']),
            int(env.get('LOCAL_WORLD_SIZE', world)))


def init_process_group(device, rank=None, world=None, init_method=None,
                       backend=None, timeout_s=600):
    """Join the default process group: ``backend``, by default NCCL for a
    CUDA ``device`` and gloo for the CPU (gloo also takes CUDA tensors,
    through the host: two ranks on one card, which NCCL refuses); ``rank``
    and ``world`` with ``init_method`` (e.g. 'tcp://localhost:29500'), or
    the torchrun environment ('env://'). Raises where the group cannot
    start."""
    import torch.distributed as dist
    backend = backend or ('nccl' if torch.device(device).type == 'cuda'
                          else 'gloo')
    kw = {}
    if rank is not None:
        kw = dict(rank=rank, world_size=world)
    dist.init_process_group(
        backend, init_method=init_method or 'env://',
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def free_port():
    """A free TCP port on localhost (for a process group's rendezvous)."""
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _gather(x):
    """[x of every rank] in rank order (x the same shape on every rank).
    gloo gathers host tensors: a CUDA x is staged through pinned host
    buffers there (kept by PyTorch's caching host allocator)."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if not (x.is_cuda and dist.get_backend() == 'gloo'):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return parts

    def pinned():
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    src = pinned()
    src.copy_(x)
    parts = [pinned() for _ in range(world)]
    dist.all_gather(parts, src)
    return [p.to(x.device, non_blocking=True) for p in parts]


def _ordered_sum(parts):
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, concatenated in rank order along axis 0; the
    backward gives each rank the sum over ranks (in rank order) of the
    gradient of its own rows."""

    @staticmethod
    def forward(ctx, x, rank):
        ctx.rank, ctx.rows = rank, x.shape[0]
        return torch.cat(_gather(x))

    @staticmethod
    def backward(ctx, g):
        total = _ordered_sum(_gather(g))
        return total.narrow(0, ctx.rank * ctx.rows, ctx.rows), None


def gather_rows(x):
    """Inside ``data_parallel``: the rows (axis 0) of ``x`` from every rank,
    in rank order, under autograd (the train-mode batch norm's per-sample
    statistics over the global batch); outside it, ``x``."""
    dp = current()
    return x if dp is None else _GatherRows.apply(x, dp.rank)


def gather_detached(x, dim=0):
    """Inside ``data_parallel``: ``x`` of every rank concatenated in rank
    order along ``dim``, without gradient; outside it, ``x``."""
    dp = current()
    if dp is None:
        return x
    return torch.cat(_gather(x.detach()), dim=dim)


def global_rows(draw, shape):
    """``draw(shape)`` of a random tensor whose axis 0 is the batch; inside
    ``data_parallel`` this rank's rows of ``draw`` at the global batch, so
    that every rank draws the one-device step's numbers (each rank holds
    the same generator state)."""
    dp = current()
    if dp is None:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * dp.world,) + tuple(shape[1:]))
    return full.narrow(0, dp.rank * n, n)


def all_reduce_grads(params):
    """Inside ``data_parallel``: every ``p.grad`` the mean over ranks (the
    sum in rank order, over the world size), bitwise equal on every rank;
    outside it nothing."""
    dp = current()
    if dp is None:
        return
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for chunk in flat.split(GRAD_CHUNK):
            chunk.copy_(_ordered_sum(_gather(chunk)).div_(dp.world))
        pos = 0
        for g in grads:
            g.copy_(flat[pos:pos + g.numel()].view_as(g))
            pos += g.numel()


def mean_over_ranks(metrics):
    """Inside ``data_parallel``: each tensor of ``metrics`` (a loss or a
    vector of terms) the mean over ranks (in rank order), in float32;
    outside it ``metrics`` as they are."""
    dp = current()
    if dp is None or not metrics:
        return metrics
    keys = sorted(metrics)
    parts = [metrics[k].detach().float() for k in keys]
    flat = torch.cat([p.reshape(-1) for p in parts])
    mean = _ordered_sum(_gather(flat)) / dp.world
    return {k: v.view_as(p) for k, p, v in zip(
        keys, parts, mean.split([p.numel() for p in parts]))}


def broadcast(value, src=0):
    """``value`` (picklable) of rank ``src`` on every rank (inside
    ``data_parallel``; outside it, ``value``)."""
    if current() is None:
        return value
    import torch.distributed as dist
    obj = [value]
    dist.broadcast_object_list(obj, src=src)
    return obj[0]


def spatial_halo_apply(fn, x, mesh=None, halo=0, axis='data'):
    """The JAX package's width-sharded op with halo exchange, used by its
    mesh-sharded labeling: not ported (the port labels on one card with a
    union-find kernel; a cross-card border merge is its counterpart)."""
    raise roadmap.not_ported('spatial_halo_apply (mesh-sharded labeling)',
                             roadmap.SERVING)
