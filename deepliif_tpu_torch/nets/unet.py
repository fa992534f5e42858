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

int8 (``set_int8``): the quantized ``downconv`` and ``upconv`` of each block
take the int8 route of ``layers`` (the ``conv_s8`` kernel); the min_ch gate
leaves the outermost block's (3 channels in, 3 out) float. ``calibrate``
replays the float net and records each conv's input (the unpadded input:
these convs pad inside).

Norms: those of ``layers.norm_layer``; with instance norm every conv
carries a bias (the reference rule), the outermost up conv always does.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import roadmap
from . import layers as L


class UnetSkipConnectionBlock(nn.Module):
    def __init__(self, outer_nc, inner_nc, input_nc=None, submodule=None,
                 outermost=False, innermost=False, use_dropout=False,
                 norm='batch'):
        super().__init__()
        self.outermost = outermost
        self.innermost = innermost
        self.norm = norm
        bias = L.norm_use_bias(norm)
        if input_nc is None:
            input_nc = outer_nc
        downconv = nn.Conv2d(input_nc, inner_nc, 4, 2, 1, bias=bias)
        if outermost:
            up = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1)
            seq = [downconv, submodule, nn.ReLU(True), up, nn.Tanh()]
        elif innermost:
            up = nn.ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1, bias=bias)
            seq = [nn.LeakyReLU(0.2, True), downconv, nn.ReLU(True), up,
                   L.norm_layer(norm, outer_nc)]
        else:
            up = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1,
                                    bias=bias)
            seq = [nn.LeakyReLU(0.2, True), downconv,
                   L.norm_layer(norm, inner_nc), submodule, nn.ReLU(True), up,
                   L.norm_layer(norm, outer_nc)]
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

    def run(self, x, cast, path='', calib=None):
        """Block forward; ``cast`` maps a conv parameter to what its conv
        takes (its compute-dtype copy or its ``Int8Conv``); ``path`` is the
        block's JAX param path prefix ('', 'sub/', ...) and ``calib`` a
        calibration view recording the convs' inputs under it."""
        m = self.model
        sub = path + 'sub/'
        if self.outermost:
            L.record(calib, path + 'downconv', x)
            h = L.conv2d(x, cast(m[0].weight), cast(m[0].bias), 2, 1)
            h = L.relu(m[1].run(h, cast, sub, calib))
            L.record(calib, path + 'upconv', h)
            h = L.conv_transpose2d(h, cast(m[3].weight), cast(m[3].bias), 2,
                                   1, 0)
            return L.tanh(h)
        h = L.leaky_relu(x, 0.2)
        L.record(calib, path + 'downconv', h)
        h = L.conv2d(h, cast(m[1].weight), cast(m[1].bias), 2, 1)
        if self.innermost:
            h = L.relu(h)
            L.record(calib, path + 'upconv', h)
            h = L.conv_transpose2d(h, cast(m[3].weight), cast(m[3].bias), 2,
                                   1, 0)
            h = L.apply_norm(h, self.norm, m[4])
        else:
            h = L.apply_norm(h, self.norm, m[2])
            h = L.relu(m[3].run(h, cast, sub, calib))
            L.record(calib, path + 'upconv', h)
            h = L.conv_transpose2d(h, cast(m[5].weight), cast(m[5].bias), 2,
                                   1, 0)
            h = L.apply_norm(h, self.norm, m[6])
        return torch.cat([x, h], dim=1)


class UnetGenerator(nn.Module):
    def __init__(self, input_nc, output_nc, num_downs, ngf=64, norm='batch',
                 use_dropout=True):
        super().__init__()
        self.norm = norm
        blk = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True,
                                      norm=norm)
        for _ in range(num_downs - 5):
            blk = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=blk,
                                          use_dropout=use_dropout, norm=norm)
        blk = UnetSkipConnectionBlock(ngf * 4, ngf * 8, submodule=blk,
                                      norm=norm)
        blk = UnetSkipConnectionBlock(ngf * 2, ngf * 4, submodule=blk,
                                      norm=norm)
        blk = UnetSkipConnectionBlock(ngf, ngf * 2, submodule=blk, norm=norm)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc,
                                             submodule=blk, outermost=True,
                                             norm=norm)
        self.compute_dtype = torch.float32
        # int8 (set_int8): the quantized convs' scales by JAX path
        self.int8 = {}
        self._int8_convs = L.Int8Cache()
        self._casts = L.CastCache()
        self._spectral = L.SpectralCache()

    def jax_layout(self):
        return [(p, f'model.{prefix}', kind)
                for p, prefix, kind in self.model.jax_layout()]

    def conv_layout(self):
        """(JAX path joined by '/', weight, kind) of every conv and
        conv-transpose."""
        return [('/'.join(path), self.get_submodule(prefix).weight, kind)
                for path, prefix, kind in self.jax_layout() if kind != 'norm']

    def set_int8(self, scales):
        """Quantize the convs named in ``scales`` ({JAX path: calibrated max
        |x| of its input, scalar or (C_in,), or None for per-sample dynamic
        scales}); every other conv keeps the compute dtype."""
        self.int8 = dict(scales)
        self._int8_convs = L.Int8Cache()

    def _cast(self, int8=True):
        """Function param -> what its conv takes: the ``Int8Conv`` of a
        quantized conv (``int8``), else the weight or bias in the compute
        dtype (cached casts of every conv and conv-transpose weight and
        bias; with spectral norm the normalized weights)."""
        casts = {}
        if self.compute_dtype != torch.float32:
            params = [p for mod in self.modules()
                      if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d))
                      for p in (mod.weight, mod.bias) if p is not None]
            casts = self._casts.get({id(p): p for p in params},
                                    self.compute_dtype)
        if self.norm == 'spectral':
            casts = {**casts, **self._spectral.get(self, self.compute_dtype)}
        q = {}
        if int8 and self.int8:
            q = self._int8_convs.get(
                [c for c in self.conv_layout() if c[0] in self.int8],
                self.int8, self.compute_dtype)
        return L.cast_function(casts, q, self.norm == 'spectral')

    def forward(self, x):
        """(B, C_in, H, W) in any float dtype -> output in the compute
        dtype."""
        if self.training:
            raise roadmap.not_ported('training', roadmap.TRAINING)
        return self.model.run(x.to(self.compute_dtype), self._cast())

    def calibrate(self, x, calib):
        """The float forward of ``x`` (float weights in the compute dtype),
        recording each conv's input through ``calib``; returns the
        output."""
        return self.model.run(x.to(self.compute_dtype), self._cast(int8=False),
                              '', calib)
