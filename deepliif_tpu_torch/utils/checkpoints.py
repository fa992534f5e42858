"""Checkpoints into and out of the port's modules, and the weight bridge to
JAX trees.

Native model dirs hold one ``{epoch}_net_{group}.npz`` per net group (G,
GS, ...), written by deepliif_tpu.utils.checkpoints: keys are the JAX
param-tree paths joined by '/', and a group of identical architectures is
stacked along a leading net axis; a group of mixed architectures is a list
keyed '0/...', '1/...' (``group_trees``). Reference model dirs hold torch
state dicts (``{epoch}_net_{name}.pth`` or TorchScript ``{name}.pt``) that
load into the modules as they are.

``save_networks`` writes the native layout from the modules (the port's
``serialize``), the counterpart of deepliif_tpu.utils.checkpoints
``save_networks``.

``params_from_jax`` / ``params_to_jax`` map one net's JAX param tree (numpy
arrays, NHWC/HWIO layouts) to and from the module's state dict; they are
the inverse of deepliif_tpu.utils.torch_import's conv_from_torch,
convT_from_torch and norm_from_torch. The weight maps (``weight_from_hwio``
and its inverse ``weight_to_hwio``, which the fused translator stages also
use) are:

  conv            HWIO                -> OIHW  (transpose 3, 2, 0, 1)
  conv_transpose  HWIO, spatially
                  flipped             -> IOHW  (transpose 2, 3, 0, 1 + flip)
  norm            scale / bias        -> weight / bias
  spectral norm   u (conv nodes)      -> spectral_u (a buffer of the conv)
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

_RUNNING_STATS = ('running_mean', 'running_var', 'num_batches_tracked')


def _get(tree, path, default=None):
    """tree[path[0]][path[1]]...; ``default`` (when given) where a key is
    missing: an npz holds no key for an empty node."""
    for k in path:
        if default is not None and (tree is None or k not in tree):
            return default
        tree = tree[k]
    return tree


def weight_from_hwio(w, kind):
    """A JAX-layout conv weight (HWIO tensor) -> the torch module's layout:
    kind 'conv' -> OIHW; 'convT' (the JAX conv-transpose kernel, stored in
    the forward-conv layout, spatially flipped) -> IOHW. A view or a
    flipped copy; not necessarily contiguous."""
    if kind == 'conv':
        return w.permute(3, 2, 0, 1)
    return w.permute(2, 3, 0, 1).flip(2, 3)


def weight_to_hwio(w, kind):
    """The inverse of ``weight_from_hwio``: a torch conv (OIHW) or
    conv-transpose (IOHW) weight -> the JAX HWIO layout."""
    if kind == 'conv':
        return w.permute(2, 3, 1, 0)
    return w.flip(2, 3).permute(2, 3, 0, 1)


def params_from_jax(net, tree):
    """JAX param tree of one net (numpy or array-likes) -> state dict of
    ``net`` (float32 torch tensors)."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32, order='C'))

    sd = {}
    for path, prefix, kind in net.jax_layout():
        if kind == 'norm':
            p = _get(tree, path, {})
            if not p:       # a norm without parameters
                continue
            sd[f'{prefix}.weight'] = f32(p['scale'])
            sd[f'{prefix}.bias'] = f32(p['bias'])
            continue
        p = _get(tree, path)
        sd[f'{prefix}.weight'] = weight_from_hwio(f32(p['w']),
                                                  kind).contiguous()
        if 'b' in p:
            sd[f'{prefix}.bias'] = f32(p['b'])
        if 'u' in p:
            sd[f'{prefix}.spectral_u'] = f32(p['u'])
    return sd


def params_to_jax(net, state_dict=None):
    """State dict of ``net`` (default: its own) -> JAX param tree of numpy
    float32 arrays, as deepliif_tpu.utils.torch_import builds it."""
    sd = net.state_dict() if state_dict is None else state_dict

    def arr(key):
        return sd[key].detach().cpu().numpy()

    tree = {}
    for path, prefix, kind in net.jax_layout():
        if kind == 'norm':
            node = {'scale': arr(f'{prefix}.weight'),
                    'bias': arr(f'{prefix}.bias')} \
                if f'{prefix}.weight' in sd else {}
        else:
            w = weight_to_hwio(sd[f'{prefix}.weight'].detach().cpu(), kind)
            node = {'w': np.ascontiguousarray(w.numpy())}
            if f'{prefix}.bias' in sd:
                node['b'] = arr(f'{prefix}.bias')
            if f'{prefix}.spectral_u' in sd:
                node['u'] = arr(f'{prefix}.spectral_u')
        parent = tree
        for k in path[:-1]:
            parent = parent.setdefault(k, {})
        parent[path[-1]] = node
    return tree


def flatten_tree(tree, prefix=''):
    """Nested dict -> {'a/b/w': array} in sorted key order, the npz key
    scheme of deepliif_tpu.utils.checkpoints (empty dicts and None carry no
    leaves)."""
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key + '/'))
        elif v is not None:
            flat[key] = np.asarray(v)
    return flat


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split('/')
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def group_trees(flat, n_nets):
    """Flat npz group -> list of ``n_nets`` per-net trees. Two layouts, as
    the JAX package writes them (deepliif_tpu/models/deepliif.py
    init_params): a uniform group stacks each leaf along a leading net axis
    ('a/b/w' of shape (n_nets, ...)); a group of mixed architectures is a
    list of per-net trees, keyed '0/a/b/w', '1/...'."""
    heads = {k.split('/', 1)[0] for k in flat}
    if heads == {str(i) for i in range(n_nets)} and all('/' in k
                                                        for k in flat):
        per_net = [{} for _ in range(n_nets)]
        for k, v in flat.items():
            i, rest = k.split('/', 1)
            per_net[int(i)][rest] = v
        return [unflatten(f) for f in per_net]
    for k, v in flat.items():
        if v.ndim == 0 or v.shape[0] != n_nets:
            raise ValueError(f'{k}: expected a group of {n_nets} stacked nets '
                             f'or keys 0/.. to {n_nets - 1}/.., got shape '
                             f'{v.shape}')
    return [unflatten({k: v[i] for k, v in flat.items()})
            for i in range(n_nets)]


def group_flat(nets):
    """The npz dict of one net group (a list of modules), in the layout
    ``group_trees`` reads and the JAX package writes: each leaf stacked
    along a leading net axis when the nets share one architecture (every
    key and shape equal; one net is a group of one), else each net's keys
    under '0/', '1/', ..."""
    flats = [flatten_tree(params_to_jax(net)) for net in nets]
    layout = {k: v.shape for k, v in flats[0].items()}
    if all({k: v.shape for k, v in f.items()} == layout for f in flats[1:]):
        return {k: np.stack([f[k] for f in flats]) for k in flats[0]}
    return {f'{i}/{k}': v for i, f in enumerate(flats) for k, v in f.items()}


def save_npz(path, flat):
    """Atomic write of ``flat`` to ``path`` (a temp file, then os.replace):
    a crash mid-save never truncates the file a later load reads."""
    tmp = f'{path}.tmp-{os.getpid()}-{threading.get_ident()}'
    try:
        np.savez(tmp, **flat)
        # np.savez appends .npz when the name lacks it
        written = tmp if os.path.exists(tmp) else tmp + '.npz'
        os.replace(written, path)
    finally:
        for cand in (tmp, tmp + '.npz'):
            if os.path.exists(cand):
                os.remove(cand)


def save_networks(save_dir, nets, epoch='latest'):
    """Write each non-empty group of ``nets`` (``named_groups()``: G / GS,
    G / GS of DeepLIIFExt, G of SDG, GA / GB of CycleGAN) as
    ``{epoch}_net_{group}.npz`` in the JAX key layout; a numbered epoch
    also refreshes ``latest_net_{group}.npz``."""
    os.makedirs(save_dir, exist_ok=True)
    epochs = [str(epoch)] if str(epoch) == 'latest' else [str(epoch),
                                                          'latest']
    for name, group in nets.named_groups():
        if not len(group):
            continue
        flat = group_flat(group)
        for ep in epochs:
            save_npz(os.path.join(save_dir, f'{ep}_net_{name}.npz'), flat)


def load_group_npz(path, nets):
    """Load a native ``{epoch}_net_{group}.npz`` into the list of modules
    ``nets`` (strict: every key of every module must be present)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    for net, tree in zip(nets, group_trees(flat, len(nets))):
        net.load_state_dict(params_from_jax(net, tree), strict=True)


def has_native_checkpoint(model_dir, epoch='latest'):
    """A native dir holds ``{epoch}_net_G.npz``, or ``{epoch}_net_GA.npz``
    (CycleGAN)."""
    return any(os.path.exists(os.path.join(model_dir,
                                           f'{epoch}_net_{g}.npz'))
               for g in ('G', 'GA'))


def find_net_file(model_dir, name, epoch='latest'):
    """Reference net checkpoint: eager {epoch}_net_{name}.pth, else {name}.pt."""
    pth = os.path.join(model_dir, f'{epoch}_net_{name}.pth')
    if os.path.exists(pth):
        return pth
    pt = os.path.join(model_dir, f'{name}.pt')
    if os.path.exists(pt):
        return pt
    return None


def load_reference_state_dict(net, path):
    """Load a reference ``.pth`` state dict or TorchScript ``.pt`` archive
    into ``net`` with ``strict=True``. A DataParallel 'module.' prefix is
    stripped, and BatchNorm running statistics are dropped: inference uses
    per-sample statistics (layers.batch_stat_norm)."""
    if path.endswith('.pt'):
        sd = torch.jit.load(path, map_location='cpu').state_dict()
    else:
        sd = torch.load(path, map_location='cpu', weights_only=True)
    sd = {(k[len('module.'):] if k.startswith('module.') else k): v
          for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if k.rsplit('.', 1)[-1] not in _RUNNING_STATS}
    if not any(k.endswith('.spectral_u') for k in sd):
        # a reference dir carries no power-iteration vectors: its convs run
        # the weights as they are, as the JAX package's import gives them
        from ..nets import layers
        layers.drop_spectral_buffers(net)
    net.load_state_dict(sd, strict=True)
