"""ResNet generator (c7s1-64, 2x down, n residual blocks, 2x up, c7s1-out,
tanh) for inference.

Port of deepliif_tpu/nets/resnet.py with the reference module layout
(reference networks.py ResnetGenerator): ``model`` is an ``nn.Sequential``
whose indices match the reference state dict, residual blocks hold their
layers in ``model.N.conv_block.M`` (Dropout slot included), so reference
``.pth`` files load with ``load_state_dict(strict=True)``.

Inference runs the residual trunk through
``ops.fused_resblock.resblock_chain`` in NHWC (float32 or bfloat16, the
net's ``compute_dtype``): the CUDA kernels for a CUDA tensor, their plain
twins for a CPU tensor. The head and tail are stock PyTorch convs with the
per-sample batch-stat norm of ``layers``. Parameters stay float32; conv
weights are cast to the compute dtype, and the trunk weights laid out (and
quantized), once per weight version.

int8 (``set_int8``, the JAX package's ``quantize_conv_tree_int8`` for one
net): the quantized down convs and up conv-transposes take the int8 route
of ``layers`` (the ``conv_s8`` kernel); the trunk runs
``resblock_chain_int8`` where the JAX package's fused gate would
(``int8_chain_mode``: every resblock conv static, or every one dynamic;
C % 128 == 0 and H, W % 16 == 0 at the trunk), else the unfused int8
trunk, one ``layers.conv2d`` per resblock conv. ``calibrate`` replays the
net in float on the unfused trunk and records each quantizable conv's
input (``layers.ActCalibration``).

``fuse_stages = True`` (bfloat16 only) runs the fused translator stages
instead, the counterpart of the JAX package's ``_apply_fused``
(``DEEPLIIF_FUSE_STAGES=1``): the down convs and up conv-transposes run
the kernels of ``labs.fused_stages``, each applying the previous norm's
affine and ReLU to its input and taking its own output statistics, so no
norm makes a pass of its own, and the tail kernel applies up1's norm
affine and ReLU, the pad, the 7x7 conv, the bias and tanh in one pass
(the JAX fused path runs that tail in XLA, with the same rounding points).
Where the JAX package would fall back to the unfused path
(``fused_stages_gate``), the port raises.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import roadmap
from ..labs import fused_stages as FS
from ..ops import fused_resblock as FR, quant
from ..utils.checkpoints import weight_to_hwio
from . import layers as L


def fused_stages_gate(dtype, int8=False, trunk_c=None, hw=None):
    """Raise ValueError where the fused translator stages do not apply:
    the gate of the JAX package (deepliif_tpu/nets/resnet.py apply,
    :217-230; there, it falls back to the unfused path without a word)
    for a compute ``dtype``, an int8 trunk, the trunk width ``trunk_c``
    and the input size ``hw`` (H, W), each checked when given."""
    if int8:
        raise ValueError(
            'fuse_stages does not run at int8: the JAX package\'s gate passes '
            'there (its int8 compute dtype is bfloat16) and its fused path '
            'then runs the trunk in bfloat16 on the float weights, dropping '
            'the int8 trunk without a word; the port refuses')
    if dtype != torch.bfloat16:
        raise ValueError(f'fuse_stages runs in bfloat16 only (the JAX gate '
                         f'x.dtype == bfloat16), got {dtype}')
    if trunk_c is not None and trunk_c % 128:
        raise ValueError(f'fuse_stages needs a trunk width C % 128 == 0 (the '
                         f'JAX gate), got C={trunk_c}')
    if hw is not None:
        h, w = hw
        if h % 16 or w % 16 or (h // 4) % 16 or (w // 4) % 16:
            raise ValueError(f'fuse_stages needs H, W % 16 == 0 at the input '
                             f'and at the trunk (H/4, W/4; the JAX gate), '
                             f'got {h}x{w}')


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
            raise roadmap.not_ported(f'norm [{norm}]', roadmap.FAMILIES)
        if padding_type not in ('reflect', 'zero'):
            raise roadmap.not_ported(f'padding [{padding_type}]',
                                     roadmap.FAMILIES)
        if upsample != 'convtranspose':
            raise roadmap.not_ported(f'upsample [{upsample}]',
                                     roadmap.FAMILIES)
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
        self.compute_dtype = torch.float32
        self.fuse_stages = False
        # int8 (set_int8): the quantized convs' scales by JAX name, and the
        # trunk's mode: None (float), 'static', 'dynamic' or 'unfused'
        self.int8 = {}
        self.int8_mode = None
        self._int8_convs = L.Int8Cache()
        self._casts = L.CastCache()
        self._trunk_casts = L.CastCache()
        self._stage_casts = L.CastCache()
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

    # -- precision ----------------------------------------------------------

    def conv_layout(self):
        """(JAX name, weight, kind) of every conv and conv-transpose."""
        return [(path[0], self.get_submodule(prefix).weight, kind)
                for path, prefix, kind in self.jax_layout() if kind != 'norm']

    def resblock_convs(self):
        return [f'res{i}_conv{j}' for i in range(self.n_blocks)
                for j in (1, 2)]

    def set_int8(self, scales):
        """Quantize the convs named in ``scales`` ({JAX name: calibrated
        max |x| of its input, scalar or (C_in,), or None for per-sample
        dynamic scales}); every other conv keeps the compute dtype. The
        trunk's mode is the JAX package's ``int8_chain_mode``: 'static'
        when every resblock conv has a scale, 'dynamic' when none has (the
        fused int8 kernel), 'unfused' when some have (the unfused int8
        trunk), None when no resblock conv is quantized."""
        self.int8 = dict(scales)
        res = self.resblock_convs()
        quantized = [n for n in res if n in self.int8]
        n_static = sum(self.int8[n] is not None for n in quantized)
        if not quantized:
            self.int8_mode = None
        elif len(quantized) == len(res) and n_static in (0, len(res)):
            self.int8_mode = 'static' if n_static else 'dynamic'
        else:
            self.int8_mode = 'unfused'
        self._int8_convs = L.Int8Cache()
        self._trunk_key = None

    def _cast(self, int8=True):
        """Function param -> what its conv takes: the ``Int8Conv`` of a
        quantized conv (``int8``), else the weight or bias in the compute
        dtype (cached casts)."""
        m = self.model
        up = 10 + self.n_blocks
        params = [m[1].weight, m[4].weight, m[7].weight, m[up].weight,
                  m[up + 3].weight, m[up + 7].weight, m[up + 7].bias]
        casts = {}
        if self.compute_dtype != torch.float32:
            casts = self._casts.get({id(p): p for p in params},
                                    self.compute_dtype)
            if not int8:
                # the float trunk, unfused: only the calibration replay
                trunk = [c.weight for b in self.blocks
                         for c in (b.conv1, b.conv2)]
                casts = {**casts, **self._trunk_casts.get(
                    {id(p): p for p in trunk}, self.compute_dtype)}
        q = {}
        if int8 and self.int8:
            q = self._int8_convs.get(
                [c for c in self.conv_layout() if c[0] in self.int8],
                self.int8, self.compute_dtype)
        return lambda p: q[id(p)] if id(p) in q else casts.get(id(p), p)

    # -- inference ----------------------------------------------------------

    def trunk_blocks(self):
        """The residual blocks in ``resblock_chain`` form (or
        ``resblock_chain_int8`` form in int8 mode 'static' or 'dynamic'):
        HWIO weights laid
        out, cast or quantized once (rebuilt only when a weight changes or
        moves, or the precision does) and the live float32 norm
        parameters."""
        blocks = self.blocks
        key = (self.compute_dtype, self.int8_mode) + tuple(
            (b.conv1.weight.data_ptr(), b.conv1.weight._version,
             b.conv2.weight.data_ptr(), b.conv2.weight._version)
            for b in blocks)
        if key != self._trunk_key:
            with torch.no_grad():
                self._trunk = [self._trunk_block(i, b)
                               for i, b in enumerate(blocks)]
            self._trunk_key = key
        return [{**t, 'norm1': {'scale': b.norm1.weight, 'bias': b.norm1.bias},
                 'norm2': {'scale': b.norm2.weight, 'bias': b.norm2.bias}}
                for t, b in zip(self._trunk, blocks)]

    def _trunk_block(self, i, b):
        out = {}
        for j, conv in ((1, b.conv1), (2, b.conv2)):
            w = conv.weight.detach().permute(2, 3, 1, 0).contiguous()
            if self.int8_mode == 'static':
                out[f'w{j}q'], out[f'w{j}s'], out[f'a{j}'] = \
                    quant.quantize_conv_int8_static(
                        w, self.int8[f'res{i}_conv{j}'])
            elif self.int8_mode == 'dynamic':
                out[f'w{j}q'], out[f'w{j}s'] = quant.quantize_conv_int8(w)
            else:
                out[f'w{j}'] = w.to(self.compute_dtype)
        return out

    def head(self, x, cast=None, calib=None):
        """(B, C_in, H, W) -> trunk input (B, H/4, W/4, 4 ngf), NHWC.
        ``cast``: as ``_cast()`` returns (default: the net's own);
        ``calib``: a calibration view (``layers.ActCalibration.at``)
        recording the down convs' inputs."""
        m = self.model
        cast = cast or self._cast()
        x = L.pad2d(x, 3, self.padding_type)
        x = L.conv2d(x, cast(m[1].weight))
        x = L.relu(L.batch_stat_norm(x, m[2].weight, m[2].bias))
        for i, idx in enumerate((4, 7)):
            L.record(calib, f'down{i}_conv', x)
            x = L.conv2d(x, cast(m[idx].weight), None, 2, 1)
            x = L.relu(L.batch_stat_norm(x, m[idx + 1].weight, m[idx + 1].bias))
        return x.permute(0, 2, 3, 1).contiguous()

    def trunk(self, x, cast=None, calib=None):
        """NHWC trunk: the fused resblock chain (float, or int8 where the
        JAX package's fused gate admits it), else, and while calibrating,
        the unfused trunk."""
        _, h, w, c = x.shape
        if calib is None and self.int8_mode is None:
            return FR.resblock_chain(x, self.trunk_blocks(),
                                     padding=self.padding_type)
        if (calib is None and self.int8_mode in ('static', 'dynamic')
                and c % 128 == 0 and h % 16 == 0 and w % 16 == 0):
            # the JAX package's fused-kernel gate (deepliif_tpu/nets/
            # resnet.py _fused_ok and int8_chain_mode)
            return FR.resblock_chain_int8(x, self.trunk_blocks(),
                                          padding=self.padding_type,
                                          dynamic=self.int8_mode == 'dynamic')
        return self.trunk_unfused(x.permute(0, 3, 1, 2), cast or self._cast(),
                                  calib).permute(0, 2, 3, 1)

    def trunk_unfused(self, x, cast, calib=None):
        """(B, C, H, W) -> the trunk's output, one ``layers.conv2d`` per
        resblock conv (the JAX package's unfused loop): a reflect block pads
        first and records the padded input, a zero block pads inside the
        conv; norm per sample, ReLU after the first conv, the residual add
        in x.dtype."""
        reflect = self.padding_type == 'reflect'
        for i, b in enumerate(self.blocks):
            h = x
            for j, conv, norm in ((1, b.conv1, b.norm1),
                                  (2, b.conv2, b.norm2)):
                if reflect:
                    h = L.pad2d(h, 1, 'reflect')
                L.record(calib, f'res{i}_conv{j}', h)
                h = L.conv2d(h, cast(conv.weight), None, 1,
                             0 if reflect else 1)
                h = L.batch_stat_norm(h, norm.weight, norm.bias)
                if j == 1:
                    h = L.relu(h)
            x = x + h
        return x

    def tail(self, x, cast=None, calib=None):
        """NHWC trunk output -> (B, C_out, H, W) in [-1, 1]."""
        m = self.model
        cast = cast or self._cast()
        x = x.permute(0, 3, 1, 2)
        idx = 10 + self.n_blocks
        for i in range(2):
            L.record(calib, f'up{i}_conv', x)
            x = L.conv_transpose2d(x, cast(m[idx].weight), None, 2, 1, 1)
            x = L.relu(L.batch_stat_norm(x, m[idx + 1].weight, m[idx + 1].bias))
            idx += 3
        x = L.pad2d(x, 3, self.padding_type)
        x = L.conv2d(x, cast(m[idx + 1].weight), cast(m[idx + 1].bias))
        return L.tanh(x)

    def calibrate(self, x, calib):
        """The float forward of ``x`` (the JAX package's calibration replay:
        float weights in the compute dtype, the unfused trunk), recording
        each conv's input through ``calib``; returns the output."""
        cast = self._cast(int8=False)
        x = x.to(self.compute_dtype)
        return self.tail(self.trunk(self.head(x, cast, calib), cast, calib),
                         cast, calib)

    # -- fused translator stages ------------------------------------------

    def stage_weights(self):
        """The down-conv, up-conv-transpose and tail kernels in the JAX HWIO
        layout (``weight_to_hwio``) and the tail bias, cast to the compute
        dtype once per weight version."""
        m, up = self.model, 10 + self.n_blocks
        tensors = {'down0': m[4].weight, 'down1': m[7].weight,
                   'up0': m[up].weight, 'up1': m[up + 3].weight,
                   'tail': m[up + 7].weight, 'tail_b': m[up + 7].bias}

        def layout(k, t):
            if k == 'tail_b':
                return t
            return weight_to_hwio(t, 'convT' if k.startswith('up') else 'conv')
        return self._stage_casts.get(tensors, self.compute_dtype, layout)

    def fused_stages(self, x):
        """(B, C_in, H, W) bfloat16 -> output through the fused stages (the
        JAX package's ``_apply_fused``): head conv (cuDNN), its statistics
        (``plane_sums``), down0 and down1 (``conv3x3_s2_stats``, each with
        the previous norm's affine and ReLU), the norm affine and ReLU, the
        trunk, up0 (``convtranspose3_s2_stats``, no affine) and up1 (with
        up0's), then the tail (``tail_s2d_fused``: up1's norm affine and
        ReLU, pad 3, 7x7 conv, bias, tanh), which returns (B, C_out, H,
        W)."""
        m, up = self.model, 10 + self.n_blocks
        _, _, h0, w0 = x.shape
        fused_stages_gate(self.compute_dtype, bool(self.int8),
                          m[7].weight.shape[0], (h0, w0))
        cast, w = self._cast(int8=False), self.stage_weights()

        def norm(st, bn, div):
            return FR.finalize_norm(st, bn.weight, bn.bias, h0 // div,
                                    w0 // div)

        def affine_relu(y, sc, bi):
            return torch.relu(y * sc.to(y.dtype)[:, None, None]
                              + bi.to(y.dtype)[:, None, None])

        x = L.conv2d(L.pad2d(x, 3, self.padding_type), cast(m[1].weight))
        sc, bi = norm(L.plane_sums(x), m[2], 1)
        x = x.permute(0, 2, 3, 1).contiguous()
        for i, idx in enumerate((4, 7)):
            x, st = FS.conv3x3_s2_stats(x, w[f'down{i}'], in_scale=sc,
                                        in_bias=bi, in_relu=True)
            sc, bi = norm(st, m[idx + 1], 2 ** (i + 1))
        x = self.trunk(affine_relu(x, sc, bi))
        x, st = FS.convtranspose3_s2_stats(x, w['up0'])
        sc, bi = norm(st, m[up + 1], 2)
        x, st = FS.convtranspose3_s2_stats(x, w['up1'], in_scale=sc,
                                           in_bias=bi, in_relu=True)
        sc, bi = norm(st, m[up + 4], 1)
        return FS.tail_s2d_fused(x, w['tail'], w['tail_b'], in_scale=sc,
                                 in_bias=bi, in_relu=True,
                                 padding=self.padding_type)

    def forward(self, x):
        """(B, C_in, H, W) in any float dtype -> output in the compute
        dtype."""
        if self.training:
            raise roadmap.not_ported('training', roadmap.TRAINING)
        x = x.to(self.compute_dtype)
        if self.fuse_stages:
            return self.fused_stages(x)
        return self.tail(self.trunk(self.head(x)))
