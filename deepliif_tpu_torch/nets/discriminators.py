"""PatchGAN discriminators, the port of deepliif_tpu/nets/discriminators.py.

Parity with the reference NLayerDiscriminator / PixelDiscriminator
(reference networks.py:618-696), in the reference module layout (``model``
or ``net``, an ``nn.Sequential``), so reference state dicts load as they
are; ``jax_layout`` maps them to the JAX param trees (conv0 .. conv_out,
norm1 ..), for ``utils.checkpoints``. DeepLIIF uses netD='n_layers' with
n_layers_D=4 and the conditional input concat(input, output), 6 channels.

A discriminator's norm always takes batch statistics over the batch under
autograd (the JAX ``apply_norm`` default ``train=True``), in the losses of
an evaluation too. A discriminator runs in its ``compute_dtype`` (the
JAX ``define_d(dtype=d.dtype)``: bfloat16 in a DeepLIIF step at
bfloat16), its input cast to it, the weights cast (and spectrally
normalized where a conv has a ``spectral_u``) under autograd by
``layers.train_cast``; float32 statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc, ndf=64, n_layers=3, norm='batch'):
        super().__init__()
        self.norm = norm
        self.n_layers = n_layers
        bias = L.norm_use_bias(norm)
        seq = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2, True)]
        nf_mult = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf_mult = nf_mult, min(2 ** n, 8)
            seq += [nn.Conv2d(ndf * nf_prev, ndf * nf_mult, 4,
                              2 if n < n_layers else 1, 1, bias=bias),
                    L.norm_layer(norm, ndf * nf_mult), nn.LeakyReLU(0.2, True)]
        seq.append(nn.Conv2d(ndf * nf_mult, 1, 4, 1, 1))
        self.model = nn.Sequential(*seq)
        self.compute_dtype = torch.float32

    def jax_layout(self):
        """(JAX param path, torch module prefix, kind), as
        ``ResnetGenerator.jax_layout``."""
        out = [(('conv0',), 'model.0', 'conv')]
        for n in range(1, self.n_layers + 1):
            i = 2 + 3 * (n - 1)
            out += [((f'conv{n}',), f'model.{i}', 'conv'),
                    ((f'norm{n}',), f'model.{i + 1}', 'norm')]
        out.append((('conv_out',), f'model.{2 + 3 * self.n_layers}', 'conv'))
        return out

    def patch_size(self, s):
        """The patch map's size along a side of ``s`` pixels (0: empty):
        4x4 convs with pad 1, stride 2 up to conv n_layers - 1, then 1."""
        for n in range(self.n_layers + 2):
            if s + 2 < 4:
                return 0
            s = (s + 2 - 4) // (2 if n < self.n_layers else 1) + 1
        return s

    def forward(self, x):
        if min(self.patch_size(x.shape[2]), self.patch_size(x.shape[3])) < 1:
            raise ValueError(
                f'NLayerDiscriminator(n_layers={self.n_layers}) patch map is '
                f'empty for this input size; use a larger image (>= '
                f'{2 ** self.n_layers} * 4) or fewer layers')
        m = self.model
        dt = L.train_dtype(self)
        cast, x = L.train_cast(self, dt), x.to(dt)
        x = L.leaky_relu(L.conv2d(x, cast(m[0].weight), cast(m[0].bias), 2,
                                  1), 0.2)
        for n in range(1, self.n_layers + 1):
            i = 2 + 3 * (n - 1)
            x = L.conv2d(x, cast(m[i].weight), cast(m[i].bias),
                         2 if n < self.n_layers else 1, 1)
            x = L.leaky_relu(L.apply_norm(x, self.norm, m[i + 1], True), 0.2)
        last = m[2 + 3 * self.n_layers]
        return L.conv2d(x, cast(last.weight), cast(last.bias), 1, 1)


class PixelDiscriminator(nn.Module):
    def __init__(self, input_nc, ndf=64, norm='batch'):
        super().__init__()
        self.norm = norm
        bias = L.norm_use_bias(norm)
        self.net = nn.Sequential(
            nn.Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2, True),
            nn.Conv2d(ndf, ndf * 2, 1, bias=bias), L.norm_layer(norm, ndf * 2),
            nn.LeakyReLU(0.2, True), nn.Conv2d(ndf * 2, 1, 1, bias=bias))
        self.compute_dtype = torch.float32

    def jax_layout(self):
        return [(('conv0',), 'net.0', 'conv'), (('conv1',), 'net.2', 'conv'),
                (('norm1',), 'net.3', 'norm'), (('conv2',), 'net.5', 'conv')]

    def forward(self, x):
        n = self.net
        dt = L.train_dtype(self)
        cast, x = L.train_cast(self, dt), x.to(dt)
        x = L.leaky_relu(L.conv2d(x, cast(n[0].weight), cast(n[0].bias)), 0.2)
        x = L.conv2d(x, cast(n[2].weight), cast(n[2].bias))
        x = L.leaky_relu(L.apply_norm(x, self.norm, n[3], True), 0.2)
        return L.conv2d(x, cast(n[5].weight), cast(n[5].bias))
