"""ResNet generator (c7s1-64, 2x down, n residual blocks, 2x up, c7s1-out,
tanh) for inference.

Port of deepliif_tpu/nets/resnet.py with the reference module layout
(reference networks.py ResnetGenerator): ``model`` is an ``nn.Sequential``
whose indices match the reference state dict, residual blocks hold their
layers in ``model.N.conv_block.M`` (Dropout slot included), so reference
``.pth`` files load with ``load_state_dict(strict=True)``.

Inference runs the residual trunk through
``ops.fused_resblock.resblock_chain`` in NHWC: the CUDA kernel for a CUDA
tensor, its plain twin for a CPU tensor. The head and tail are stock
PyTorch convs with the per-sample batch-stat norm of ``layers``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import fused_resblock as FR
from . import layers as L


def _bn(c):
    # parameters only: statistics are per sample (layers.batch_stat_norm)
    return nn.BatchNorm2d(c, affine=True, track_running_stats=False)


def _pad(n, padding_type):
    return nn.ReflectionPad2d(n) if padding_type == 'reflect' else nn.ZeroPad2d(n)


class ResnetBlock(nn.Module):
    """Parameter container in the reference layout: pad1-conv3-norm-relu-
    [dropout]-pad1-conv3-norm (zero padding folds the pads into the convs).
    Inference runs all blocks at once through ``resblock_chain``."""

    def __init__(self, dim, padding_type, use_dropout):
        super().__init__()
        seq = []
        for j in range(2):
            if padding_type == 'reflect':
                seq += [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=False)]
            else:
                seq += [nn.Conv2d(dim, dim, 3, padding=1, bias=False)]
            seq.append(_bn(dim))
            if j == 0:
                seq.append(nn.ReLU(True))
                if use_dropout:
                    seq.append(nn.Dropout(0.5))
        self.conv_block = nn.Sequential(*seq)
        # conv_block indices of conv1, norm1, conv2, norm2 (plain ints, so
        # the modules are not registered a second time)
        self.param_slots = tuple(
            j for j, m in enumerate(seq)
            if isinstance(m, (nn.Conv2d, nn.BatchNorm2d)))

    @property
    def conv1(self):
        return self.conv_block[self.param_slots[0]]

    @property
    def norm1(self):
        return self.conv_block[self.param_slots[1]]

    @property
    def conv2(self):
        return self.conv_block[self.param_slots[2]]

    @property
    def norm2(self):
        return self.conv_block[self.param_slots[3]]


class ResnetGenerator(nn.Module):
    def __init__(self, input_nc, output_nc, ngf=64, n_blocks=9, norm='batch',
                 use_dropout=True, padding_type='reflect',
                 upsample='convtranspose'):
        super().__init__()
        if norm != 'batch':
            raise NotImplementedError(f'norm [{norm}] not ported (ROADMAP '
                                      'Queue 1 item 10)')
        if padding_type not in ('reflect', 'zero'):
            raise NotImplementedError(f'padding [{padding_type}] not ported')
        if upsample != 'convtranspose':
            raise NotImplementedError(f'upsample [{upsample}] not ported '
                                      '(ROADMAP Queue 1 item 10)')
        self.padding_type = padding_type
        self.n_blocks = n_blocks
        layers = [_pad(3, padding_type), nn.Conv2d(input_nc, ngf, 7, bias=False),
                  _bn(ngf), nn.ReLU(True)]
        for i in range(2):
            mult = 2 ** i
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, 2, 1, bias=False),
                       _bn(ngf * mult * 2), nn.ReLU(True)]
        layers += [ResnetBlock(ngf * 4, padding_type, use_dropout)
                   for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, 2, 1,
                                          output_padding=1, bias=False),
                       _bn(ngf * mult // 2), nn.ReLU(True)]
        layers += [_pad(3, padding_type), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)
        self._trunk_key = None
        self._trunk = None

    # -- reference layout ---------------------------------------------------

    @property
    def blocks(self):
        return [m for m in self.model if isinstance(m, ResnetBlock)]

    def jax_layout(self):
        """(JAX param path, torch module prefix, kind) for every parameter
        group, kind in conv | convT | norm: the map between this module's
        state dict and the deepliif_tpu.nets.resnet param tree."""
        out = [('head_conv', 'model.1', 'conv'), ('head_norm', 'model.2', 'norm')]
        idx = 4
        for i in range(2):
            out += [(f'down{i}_conv', f'model.{idx}', 'conv'),
                    (f'down{i}_norm', f'model.{idx + 1}', 'norm')]
            idx += 3
        for i in range(self.n_blocks):
            c1, n1, c2, n2 = self.model[idx].param_slots
            base = f'model.{idx}.conv_block'
            out += [(f'res{i}_conv1', f'{base}.{c1}', 'conv'),
                    (f'res{i}_norm1', f'{base}.{n1}', 'norm'),
                    (f'res{i}_conv2', f'{base}.{c2}', 'conv'),
                    (f'res{i}_norm2', f'{base}.{n2}', 'norm')]
            idx += 1
        for i in range(2):
            out += [(f'up{i}_conv', f'model.{idx}', 'convT'),
                    (f'up{i}_norm', f'model.{idx + 1}', 'norm')]
            idx += 3
        out.append(('tail_conv', f'model.{idx + 1}', 'conv'))
        return [((name,), prefix, kind) for name, prefix, kind in out]

    # -- inference ----------------------------------------------------------

    def trunk_blocks(self):
        """The residual blocks in ``resblock_chain`` form: HWIO weights laid
        out once (rebuilt only when a weight changes or moves) and the live
        norm parameters."""
        blocks = self.blocks
        key = tuple((b.conv1.weight.data_ptr(), b.conv1.weight._version,
                     b.conv2.weight.data_ptr(), b.conv2.weight._version)
                    for b in blocks)
        if key != self._trunk_key:
            with torch.no_grad():
                self._trunk = [
                    {'w1': b.conv1.weight.detach().permute(2, 3, 1, 0).contiguous(),
                     'w2': b.conv2.weight.detach().permute(2, 3, 1, 0).contiguous()}
                    for b in blocks]
            self._trunk_key = key
        return [{**t, 'norm1': {'scale': b.norm1.weight, 'bias': b.norm1.bias},
                 'norm2': {'scale': b.norm2.weight, 'bias': b.norm2.bias}}
                for t, b in zip(self._trunk, blocks)]

    def head(self, x):
        """(B, C_in, H, W) -> trunk input (B, H/4, W/4, 4 ngf), NHWC."""
        m = self.model
        x = L.pad2d(x, 3, self.padding_type)
        x = L.conv2d(x, m[1].weight)
        x = L.relu(L.batch_stat_norm(x, m[2].weight, m[2].bias))
        for idx in (4, 7):
            x = L.conv2d(x, m[idx].weight, None, 2, 1)
            x = L.relu(L.batch_stat_norm(x, m[idx + 1].weight, m[idx + 1].bias))
        return x.permute(0, 2, 3, 1).contiguous()

    def trunk(self, x):
        """NHWC trunk through the fused resblock chain."""
        return FR.resblock_chain(x, self.trunk_blocks(),
                                 padding=self.padding_type)

    def tail(self, x):
        """NHWC trunk output -> (B, C_out, H, W) in [-1, 1]."""
        m = self.model
        x = x.permute(0, 3, 1, 2)
        idx = 10 + self.n_blocks
        for _ in range(2):
            x = L.conv_transpose2d(x, m[idx].weight, None, 2, 1, 1)
            x = L.relu(L.batch_stat_norm(x, m[idx + 1].weight, m[idx + 1].bias))
            idx += 3
        x = L.pad2d(x, 3, self.padding_type)
        x = L.conv2d(x, m[idx + 1].weight, m[idx + 1].bias)
        return L.tanh(x)

    def forward(self, x):
        if self.training:
            raise NotImplementedError('training is not ported (ROADMAP Queue 1 '
                                      'item 11): call .eval()')
        return self.tail(self.trunk(self.head(x)))
