"""What the model families other than DeepLIIF share: their nets as groups
of generators (the JAX package's param groups G, GS, GA, GB)."""

from __future__ import annotations

from torch import nn

from .. import nets


def archs(opt, key, alt, default, n):
    """The architecture of each of ``n`` nets from the option ``key`` (or
    ``alt``): one name for all, or a list."""
    arch = getattr(opt, key, getattr(opt, alt, default))
    return (arch,) * n if isinstance(arch, str) else tuple(arch)


class ModelNets(nn.Module):
    """Groups of generators, each an ``nn.ModuleList`` attribute named as
    the JAX param group ('G', 'GS', 'GA', 'GB'). ``groups``: {name: [(C_in,
    architecture, padding, upsample[, C_out]), ...]}; C_out defaults to
    ``d.output_nc``. Every net runs in ``d.dtype``."""

    def __init__(self, d, groups):
        super().__init__()
        self.groups = tuple(groups)
        for name, specs in groups.items():
            mods = nn.ModuleList()
            for cin, arch, padding, upsample, *cout in specs:
                net = nets.define_g(cin, cout[0] if cout else d.output_nc,
                                    d.ngf, arch, d.norm, d.use_dropout,
                                    padding, upsample)
                net.compute_dtype = d.dtype
                mods.append(net)
            setattr(self, name, mods)

    def named_groups(self):
        return [(name, getattr(self, name)) for name in self.groups]
