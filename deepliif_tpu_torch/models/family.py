"""What the model families other than DeepLIIF share: their nets as groups
of generators and, for training, of discriminators (the JAX package's
param groups G, GS, GA, GB and D, DS, DA, DB), drawn and wired for
training as the flagship's (``models.deepliif``)."""

from __future__ import annotations

import torch
from torch import nn

from .. import nets
from ..nets import layers as L
from . import deepliif as dl


def archs(opt, key, alt, default, n):
    """The architecture of each of ``n`` nets from the option ``key`` (or
    ``alt``): one name for all, or a list."""
    arch = getattr(opt, key, getattr(opt, alt, default))
    return (arch,) * n if isinstance(arch, str) else tuple(arch)


class ModelNets(nn.Module):
    """Groups of nets, each an ``nn.ModuleList`` attribute named as the JAX
    param group. ``groups``: the generators, {name: [(C_in, architecture,
    padding, upsample[, C_out]), ...]}; C_out defaults to ``d.output_nc``.
    ``discriminators``: {name: [(C_in, architecture), ...]}, each built by
    ``nets.define_d`` at ``d.ndf``, ``d.n_layers_d`` and ``d.norm``. Every
    generator runs in ``d.dtype`` at inference."""

    def __init__(self, d, groups, discriminators=None):
        super().__init__()
        discriminators = discriminators or {}
        self.groups = tuple(groups) + tuple(discriminators)
        for name, specs in groups.items():
            mods = nn.ModuleList()
            for cin, arch, padding, upsample, *cout in specs:
                net = nets.define_g(cin, cout[0] if cout else d.output_nc,
                                    d.ngf, arch, d.norm, d.use_dropout,
                                    padding, upsample)
                net.compute_dtype = d.dtype
                mods.append(net)
            setattr(self, name, mods)
        for name, specs in discriminators.items():
            setattr(self, name, nn.ModuleList(
                nets.define_d(cin, d.ndf, arch, d.n_layers_d, d.norm)
                for cin, arch in specs))

    def named_groups(self):
        return [(name, getattr(self, name)) for name in self.groups]


def init_nets(nets_, d, generator=None):
    """Draw every net of ``nets_`` in place by ``d.init_type`` /
    ``d.init_gain`` from ``generator`` (``layers.init_net``), group after
    group, net after net. As in the JAX package, these families train in
    float32 at any ``precision`` (their definitions take no compute dtype)
    and, under ``norm='spectral'``, with nets of no norm layer and no conv
    bias and no ``spectral_u`` (their JAX ``def_from_opt`` applies no
    spectral normalization)."""
    for _, group in nets_.named_groups():
        for net in group:
            L.init_net(net, d.init_type, d.init_gain, generator)
    return nets_


def create_train_state(make_nets, d, opt, steps_per_epoch=1, seed=0,
                       device='cpu'):
    """``make_nets(d, with_discriminators=True)`` drawn on the CPU from a
    generator seeded ``seed`` (the same weights on every device), moved to
    ``device`` in train mode, with its optimizers
    (``deepliif.make_train_state``)."""
    nets_ = init_nets(dl.unset(lambda: make_nets(
        d, with_discriminators=True)), d, torch.Generator().manual_seed(seed))
    return dl.make_train_state(nets_, opt, steps_per_epoch, device)

