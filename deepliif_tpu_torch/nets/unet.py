"""U-Net generator with skip connections, for inference.

Port of deepliif_tpu/nets/unet.py with the reference module layout
(reference networks.py UnetGenerator / UnetSkipConnectionBlock): each block
holds ``model``, an ``nn.Sequential`` of down layers, the sub-block and up
layers, nested under ``model.model``, so reference state dicts load with
``strict=True``. 4x4 stride-2 convs down, 4x4 stride-2 transposed convs up,
LeakyReLU(0.2) before downconvs, ReLU before upconvs, skip = concat(x,
up(x)) along channels, tanh output; num_downs 5..9 -> unet_32..unet_512.
Dropout sits only on the intermediate ngf*8 blocks (depths 4..num_downs-2)
and is inert at inference. The net runs in its ``compute_dtype`` (float32
or bfloat16): parameters stay float32, conv weights and biases are cast
once per weight version, norm statistics are taken in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import roadmap
from . import layers as L


def _bn(c):
    return nn.BatchNorm2d(c, affine=True, track_running_stats=False)


class UnetSkipConnectionBlock(nn.Module):
    def __init__(self, outer_nc, inner_nc, input_nc=None, submodule=None,
                 outermost=False, innermost=False, use_dropout=False):
        super().__init__()
        self.outermost = outermost
        self.innermost = innermost
        if input_nc is None:
            input_nc = outer_nc
        downconv = nn.Conv2d(input_nc, inner_nc, 4, 2, 1, bias=False)
        if outermost:
            up = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1)
            seq = [downconv, submodule, nn.ReLU(True), up, nn.Tanh()]
        elif innermost:
            up = nn.ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1, bias=False)
            seq = [nn.LeakyReLU(0.2, True), downconv, nn.ReLU(True), up,
                   _bn(outer_nc)]
        else:
            up = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1, bias=False)
            seq = [nn.LeakyReLU(0.2, True), downconv, _bn(inner_nc), submodule,
                   nn.ReLU(True), up, _bn(outer_nc)]
            if use_dropout:
                seq.append(nn.Dropout(0.5))
        self.model = nn.Sequential(*seq)

    def jax_layout(self, path=()):
        """(JAX param path, torch prefix relative to this block, kind) for
        this block and its sub-blocks (see deepliif_tpu.nets.unet)."""
        m = self.model
        if self.outermost:
            own = [('downconv', 0, 'conv'), ('upconv', 3, 'convT')]
            sub = 1
        elif self.innermost:
            own = [('downconv', 1, 'conv'), ('upconv', 3, 'convT'),
                   ('upnorm', 4, 'norm')]
            sub = None
        else:
            own = [('downconv', 1, 'conv'), ('downnorm', 2, 'norm'),
                   ('upconv', 5, 'convT'), ('upnorm', 6, 'norm')]
            sub = 3
        out = [(path + (name,), f'model.{i}', kind) for name, i, kind in own]
        if sub is not None:
            out += [(p, f'model.{sub}.{prefix}', kind)
                    for p, prefix, kind in m[sub].jax_layout(path + ('sub',))]
        return out

    def run(self, x, cast):
        """Block forward; ``cast`` maps a conv parameter to the tensor to
        use (its compute-dtype copy)."""
        m = self.model
        if self.outermost:
            h = L.conv2d(x, cast(m[0].weight), None, 2, 1)
            h = L.relu(m[1].run(h, cast))
            h = L.conv_transpose2d(h, cast(m[3].weight), cast(m[3].bias), 2,
                                   1, 0)
            return L.tanh(h)
        h = L.leaky_relu(x, 0.2)
        h = L.conv2d(h, cast(m[1].weight), None, 2, 1)
        if self.innermost:
            h = L.relu(h)
            h = L.conv_transpose2d(h, cast(m[3].weight), None, 2, 1, 0)
            h = L.batch_stat_norm(h, m[4].weight, m[4].bias)
        else:
            h = L.batch_stat_norm(h, m[2].weight, m[2].bias)
            h = L.relu(m[3].run(h, cast))
            h = L.conv_transpose2d(h, cast(m[5].weight), None, 2, 1, 0)
            h = L.batch_stat_norm(h, m[6].weight, m[6].bias)
        return torch.cat([x, h], dim=1)


class UnetGenerator(nn.Module):
    def __init__(self, input_nc, output_nc, num_downs, ngf=64, norm='batch',
                 use_dropout=True):
        super().__init__()
        if norm != 'batch':
            raise roadmap.not_ported(f'norm [{norm}]', roadmap.FAMILIES)
        blk = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            blk = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=blk,
                                          use_dropout=use_dropout)
        blk = UnetSkipConnectionBlock(ngf * 4, ngf * 8, submodule=blk)
        blk = UnetSkipConnectionBlock(ngf * 2, ngf * 4, submodule=blk)
        blk = UnetSkipConnectionBlock(ngf, ngf * 2, submodule=blk)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc,
                                             submodule=blk, outermost=True)
        self.compute_dtype = torch.float32
        self._casts = L.CastCache()

    def jax_layout(self):
        return [(p, f'model.{prefix}', kind)
                for p, prefix, kind in self.model.jax_layout()]

    def _cast(self):
        """Function param -> param in the compute dtype (cached casts of
        every conv and conv-transpose weight and bias)."""
        if self.compute_dtype == torch.float32:
            return lambda p: p
        params = [p for mod in self.modules()
                  if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d))
                  for p in (mod.weight, mod.bias) if p is not None]
        casts = self._casts.get({id(p): p for p in params},
                                self.compute_dtype)
        return lambda p: casts[id(p)]

    def forward(self, x):
        """(B, C_in, H, W) in any float dtype -> output in the compute
        dtype."""
        if self.training:
            raise roadmap.not_ported('training', roadmap.TRAINING)
        return self.model.run(x.to(self.compute_dtype), self._cast())
