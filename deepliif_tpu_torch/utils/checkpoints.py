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
``serialize`` and ``train``; every group of every family, discriminators
included: G / GS / D / DS of DeepLIIF, DeepLIIFKD and DeepLIIFExt, G / D
of SDG, GA / GB / DA / DB of CycleGAN), the counterpart of
deepliif_tpu.utils.checkpoints ``save_networks``; ``load_networks`` reads
it back (``--continue-train``). ``save_optim`` / ``load_optim`` write and
read a training run's ``{epoch}_optim.npz`` in the JAX package's layout
(``save_pytree`` of {'g': optax state, 'd': optax state, 'step'}, keys
such as 'g/0/.count', 'g/0/.mu/G/head_conv/w', 'g/1/.count'), so a run
resumes in either package.

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
    conv-transpose (IOHW) weight -> the JAX HWIO layout, on the last four
    dims (leading dims, such as a net axis, stay in front)."""
    if kind == 'conv':
        return w.movedim((-2, -1, -3, -4), (-4, -3, -2, -1))
    return w.flip(-2, -1).movedim((-2, -1, -4, -3), (-4, -3, -2, -1))


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
    float32 arrays, as deepliif_tpu.utils.torch_import builds it. The
    tensors of ``state_dict`` may carry leading dims (a group's net axis,
    ``group_flat``); the relayout runs on their device, then one copy to
    the host per leaf."""
    sd = net.state_dict() if state_dict is None else state_dict

    def arr(key):
        return sd[key].detach().contiguous().cpu().numpy()

    tree = {}
    for path, prefix, kind in net.jax_layout():
        if kind == 'norm':
            node = {'scale': arr(f'{prefix}.weight'),
                    'bias': arr(f'{prefix}.bias')} \
                if f'{prefix}.weight' in sd else {}
        else:
            w = weight_to_hwio(sd[f'{prefix}.weight'].detach(), kind)
            node = {'w': w.contiguous().cpu().numpy()}
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


def group_flat(nets, state_dicts=None):
    """The npz dict of one net group (a list of modules), in the layout
    ``group_trees`` reads and the JAX package writes: each leaf stacked
    along a leading net axis when the nets share one architecture (one
    layout, every tensor's shape equal; one net is a group of one), else
    each net's keys under '0/', '1/', ... ``state_dicts`` (one per net,
    default the nets' own) may hold other tensors of the parameters'
    shapes, such as an optimizer's moments."""
    sds = state_dicts or [net.state_dict() for net in nets]
    shapes = [{k: v.shape for k, v in sd.items()} for sd in sds]
    layout = nets[0].jax_layout()
    if all(net.jax_layout() == layout and s == shapes[0]
           for net, s in zip(nets[1:], shapes[1:])):
        return flatten_tree(params_to_jax(nets[0], {
            k: torch.stack([sd[k].detach() for sd in sds]) for k in sds[0]}))
    return {f'{i}/{k}': v for i, (net, sd) in enumerate(zip(nets, sds))
            for k, v in flatten_tree(params_to_jax(net, sd)).items()}


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
    G / GS of DeepLIIFExt, G of SDG, GA / GB of CycleGAN, and in training
    their discriminators) as
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


def load_networks(save_dir, nets, epoch='latest'):
    """Load every non-empty group of ``nets`` from
    ``{epoch}_net_{group}.npz`` in ``save_dir`` (FileNotFoundError when
    one is missing), the JAX package's ``load_networks``."""
    for name, group in nets.named_groups():
        if not len(group):
            continue
        path = os.path.join(save_dir, f'{epoch}_net_{name}.npz')
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        load_group_npz(path, group)


def _optim_prefixes(kind, plateau):
    """(keys of the update counts, prefix of the moments) of an optax
    optimizer's state, as the JAX package's ``make_optimizer`` builds it:
    chain(transform, scale_by_schedule) (adamw: a weight-decay transform
    in between), or under ``plateau`` inject_hyperparams around
    chain(transform, scale)."""
    own = ['.count'] if kind in ('adam', 'adamw') else []
    if plateau:
        return ['.count'] + [f'.inner_state/0/{c}' for c in own], \
            '.inner_state/0/'
    sched = 2 if kind == 'adamw' else 1
    return [f'{sched}/.count'] + [f'0/{c}' for c in own], '0/'


def _optim_flat(optimizer, groups, plateau):
    from ..nets.optim import MOMENTS
    counts, inner = _optim_prefixes(optimizer.kind, plateau)
    flat = {c: np.asarray(optimizer.count, np.int32) for c in counts}
    if plateau:
        flat['.hyperparams/learning_rate'] = np.asarray(
            optimizer.param_groups[0]['lr'], np.float32)
    for m in MOMENTS[optimizer.kind]:
        for name, nets in groups:
            sds = [{k: optimizer.moment(p, m)
                    for k, p in net.named_parameters()} for net in nets]
            for k, v in group_flat(nets, sds).items():
                flat[f'{inner}.{m}/{name}/{k}'] = v
    return flat


def save_optim(path, state, plateau=False):
    """Write ``state``'s optimizer states and step (a
    ``models.deepliif.TrainState`` of any family) to ``path`` atomically,
    in the JAX package's ``{epoch}_optim.npz`` layout: 'g' over the
    generator groups (G / GS, or GA / GB), 'd' over the discriminators (D /
    DS, or DA / DB) (``plateau``: the inject_hyperparams state of the
    plateau policy, its learning rate included)."""
    flat = {'step': np.asarray(state.step, np.int32)}
    for key, optimizer, disc in (('g', state.g_opt, False),
                                 ('d', state.d_opt, True)):
        flat.update({f'{key}/{k}': v for k, v in
                     _optim_flat(optimizer, state.groups(disc),
                                 plateau).items()})
    save_npz(path, flat)


def load_optim(path, state, plateau=False):
    """Read an ``{epoch}_optim.npz`` (either package's) into ``state``: the
    optimizers' counts, moments (and under ``plateau`` learning rates) and
    the step. KeyError where a key of the layout is missing."""
    from ..nets.optim import MOMENTS
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    state.step = int(flat['step'])
    for key, optimizer, disc in (('g', state.g_opt, False),
                                 ('d', state.d_opt, True)):
        counts, inner = _optim_prefixes(optimizer.kind, plateau)
        optimizer.count = int(flat[f'{key}/{counts[0]}'])
        if plateau:
            lr = float(flat[f'{key}/.hyperparams/learning_rate'])
            for group in optimizer.param_groups:
                group['lr'] = lr
        for m in MOMENTS[optimizer.kind]:
            for name, nets in state.groups(disc):
                pre = f'{key}/{inner}.{m}/{name}/'
                sub = {k[len(pre):]: v for k, v in flat.items()
                       if k.startswith(pre)}
                if not sub:
                    raise KeyError(f'{path} holds no {pre}*')
                for net, tree in zip(nets, group_trees(sub, len(nets))):
                    sd = params_from_jax(net, tree)
                    for k, p in net.named_parameters():
                        optimizer.state[p][m] = sd[k].to(p.device)


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
