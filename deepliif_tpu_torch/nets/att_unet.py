"""Attention U-Net (8 levels, ``unet_512_attention``).

Port of deepliif_tpu/nets/att_unet.py with the reference module layout
(reference att_unet.py AttU_Net): ``Conv1``..``Conv8`` hold ``conv`` (a
4x4 stride-2 conv with bias, then BatchNorm2d and LeakyReLU(0.2) on the
middle levels, LeakyReLU alone on the outermost, ReLU on the innermost),
``Up8``..``Up2`` hold ``up`` (a 4x4 stride-2 conv-transpose without
bias, BatchNorm2d, ReLU), ``Up1`` the outermost conv-transpose with bias
and tanh, and ``Att8``..``Att2`` the additive attention gates ``W_g``,
``W_x`` (1x1 convs with bias, BatchNorm2d) and ``psi`` (a 1x1 conv to one
channel, BatchNorm2d, sigmoid) on the skip path before concat(skip, up),
so reference state dicts load with ``strict=True``.

The widths are fixed (64 to 512 channels; the ``ngf`` and ``norm``
options do not apply), and every norm is a batch norm with per-sample
statistics (``layers.batch_stat_norm``, the statistics kernel on CUDA), as
the JAX package runs it. The net runs in its ``compute_dtype`` (float32
or bfloat16): parameters stay float32, conv weights and biases are cast
once per weight version. int8 (``set_int8``, scope 'all'): every conv the
min_ch gate admits takes the int8 route of ``layers`` (the ``conv_s8``
kernel), the 1x1 attention convs with their bias among them; the
outermost convs (3 channels) and the psi convs (one channel) stay float.
``calibrate`` replays the float net and records each conv's input.

Train mode (``net.train()``, the JAX ``apply(train=True)``): every norm,
the three of each attention gate included, takes batch statistics over
(B, H, W) in float32 under autograd (``layers.train_batch_norm``); no
dropout; the weights cast to the compute dtype (and spectrally
normalized) under autograd by ``layers.train_cast``.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .resnet import check_trainable

ENC_CH = (64, 128, 256, 512, 512, 512, 512, 512)
# per up level: (conv-transpose in, out) and the attention gate's F_int
UP_CH = {8: (512, 512), 7: (1024, 512), 6: (1024, 512), 5: (1024, 512),
         4: (1024, 256), 3: (512, 128), 2: (256, 64)}
ATT_INT = {8: 512, 7: 512, 6: 512, 5: 512, 4: 128, 3: 64, 2: 32}


def _bn(c):
    return nn.BatchNorm2d(c, affine=True, track_running_stats=False)


def _holder(name, *layers):
    """A module holding one ``nn.Sequential`` under ``name`` (the
    reference's conv_block / up_conv / Attention_block attributes)."""
    m = nn.Module()
    setattr(m, name, nn.Sequential(*layers))
    return m


class AttUnetGenerator(nn.Module):
    def __init__(self, input_nc=3, output_nc=3):
        super().__init__()
        cin = input_nc
        for i, cout in enumerate(ENC_CH):
            conv = nn.Conv2d(cin, cout, 4, 2, 1, bias=True)
            if i == 0:
                layers = (conv, nn.LeakyReLU(0.2, True))
            elif i == len(ENC_CH) - 1:
                layers = (conv, nn.ReLU(True))
            else:
                layers = (conv, _bn(cout), nn.LeakyReLU(0.2, True))
            setattr(self, f'Conv{i + 1}', _holder('conv', *layers))
            cin = cout
        for lvl, (ci, co) in UP_CH.items():
            setattr(self, f'Up{lvl}', _holder(
                'up', nn.ConvTranspose2d(ci, co, 4, 2, 1, bias=False),
                _bn(co), nn.ReLU(True)))
            fi = ATT_INT[lvl]
            att = nn.Module()
            att.W_g = nn.Sequential(nn.Conv2d(co, fi, 1, bias=True), _bn(fi))
            att.W_x = nn.Sequential(nn.Conv2d(co, fi, 1, bias=True), _bn(fi))
            att.psi = nn.Sequential(nn.Conv2d(fi, 1, 1, bias=True), _bn(1),
                                    nn.Sigmoid())
            setattr(self, f'Att{lvl}', att)
        self.Up1 = _holder('up', nn.ConvTranspose2d(128, output_nc, 4, 2, 1),
                           nn.Tanh())
        self.norm = 'batch'
        self.compute_dtype = torch.float32
        # int8 (set_int8): the quantized convs' scales by JAX name
        self.int8 = {}
        self._int8_convs = L.Int8Cache()
        self._casts = L.CastCache()
        self._spectral = L.SpectralCache()

    def jax_layout(self):
        """(JAX param path, torch prefix, kind) of every parameter group
        (see deepliif_tpu.nets.att_unet ``init``)."""
        out = []
        for i in range(1, 9):
            out.append((f'conv{i}', f'Conv{i}.conv.0', 'conv'))
            if 1 < i < 8:
                out.append((f'conv{i}_norm', f'Conv{i}.conv.1', 'norm'))
        for lvl in UP_CH:
            out += [(f'up{lvl}', f'Up{lvl}.up.0', 'convT'),
                    (f'up{lvl}_norm', f'Up{lvl}.up.1', 'norm')]
        out.append(('up1', 'Up1.up.0', 'convT'))
        for lvl in UP_CH:
            for name, attr in (('wg', 'W_g'), ('wx', 'W_x'), ('psi', 'psi')):
                out += [(f'att{lvl}_{name}', f'Att{lvl}.{attr}.0', 'conv'),
                        (f'att{lvl}_{name}_norm', f'Att{lvl}.{attr}.1',
                         'norm')]
        return [((name,), prefix, kind) for name, prefix, kind in out]

    def conv_layout(self):
        """(JAX name, weight, kind) of every conv and conv-transpose."""
        return [(path[0], self.get_submodule(prefix).weight, kind)
                for path, prefix, kind in self.jax_layout() if kind != 'norm']

    def set_int8(self, scales):
        """Quantize the convs named in ``scales`` ({JAX name: calibrated max
        |x| of its input, scalar or (C_in,), or None for per-sample dynamic
        scales}); every other conv keeps the compute dtype."""
        self.int8 = dict(scales)
        self._int8_convs = L.Int8Cache()

    def _cast(self, int8=True):
        """Function param -> what its conv takes: the ``Int8Conv`` of a
        quantized conv (``int8``), else the weight or bias in the compute
        dtype (cached casts; with spectral norm the normalized weights)."""
        casts = {}
        if self.compute_dtype != torch.float32:
            params = [p for m, _ in L.conv_modules(self)
                      for p in (m.weight, m.bias) if p is not None]
            casts = self._casts.get({id(p): p for p in params},
                                    self.compute_dtype)
        spectral = L.spectral_on() and any('spectral_u' in m._buffers
                                           for m, _ in L.conv_modules(self))
        if spectral:
            casts = {**casts, **self._spectral.get(self, self.compute_dtype)}
        q = {}
        if int8 and self.int8:
            q = self._int8_convs.get(
                [c for c in self.conv_layout() if c[0] in self.int8],
                self.int8, self.compute_dtype)
        return L.cast_function(casts, q, spectral)

    @staticmethod
    def _conv_norm(x, seq, cast, calib, name, train):
        """1x1 conv with bias, then the batch norm (per sample, or with
        ``train`` over the batch)."""
        L.record(calib, name, x)
        x = L.conv2d(x, cast(seq[0].weight), cast(seq[0].bias))
        return L.apply_norm(x, 'batch', seq[1], train)

    def _attention(self, lvl, g, x, cast, calib, train):
        att = getattr(self, f'Att{lvl}')
        psi = L.relu(self._conv_norm(g, att.W_g, cast, calib, f'att{lvl}_wg',
                                     train)
                     + self._conv_norm(x, att.W_x, cast, calib,
                                       f'att{lvl}_wx', train))
        psi = self._conv_norm(psi, att.psi, cast, calib, f'att{lvl}_psi',
                              train)
        # the JAX package's sigmoid, 1 / (1 + exp(-psi)), in x's dtype
        psi = 1.0 / (1.0 + torch.exp(-psi))
        return x * psi

    def forward(self, x, rng=None):
        """(B, C_in, H, W) in any float dtype, H and W multiples of 256 ->
        output in the compute dtype; in train mode in
        ``layers.train_dtype`` under autograd (``rng`` unused: the net has
        no dropout)."""
        if self.training:
            check_trainable(self)
            dt = L.train_dtype(self)
            return self.run(x.to(dt), L.train_cast(self, dt), train=True)
        return self.run(x.to(self.compute_dtype))

    def calibrate(self, x, calib):
        """The float forward of ``x`` (float weights in the compute dtype),
        recording each conv's input through ``calib`` (a
        ``layers.ActCalibration`` view) under its JAX name."""
        return self.run(x.to(self.compute_dtype), self._cast(int8=False),
                        calib)

    def run(self, x, cast=None, calib=None, train=False):
        """The net on ``x``, already in the dtype it computes in."""
        cast = cast or self._cast()
        h = x
        enc = []
        for i in range(8):
            seq = getattr(self, f'Conv{i + 1}').conv
            L.record(calib, f'conv{i + 1}', h)
            h = L.conv2d(h, cast(seq[0].weight), cast(seq[0].bias), 2, 1)
            if i == 0:
                h = L.leaky_relu(h, 0.2)
            elif i == 7:
                h = L.relu(h)
            else:
                h = L.leaky_relu(L.apply_norm(h, 'batch', seq[1], train),
                                 0.2)
            enc.append(h)
        d = enc[7]
        for lvl, skip in zip(UP_CH, range(6, -1, -1)):
            seq = getattr(self, f'Up{lvl}').up
            L.record(calib, f'up{lvl}', d)
            d = L.conv_transpose2d(d, cast(seq[0].weight), None, 2, 1, 0)
            d = L.relu(L.apply_norm(d, 'batch', seq[1], train))
            d = torch.cat([self._attention(lvl, d, enc[skip], cast, calib,
                                           train), d], 1)
        seq = self.Up1.up
        L.record(calib, 'up1', d)
        d = L.conv_transpose2d(d, cast(seq[0].weight), cast(seq[0].bias), 2,
                               1, 0)
        return L.tanh(d)
