"""DeepLIIF flagship model, inference: 4 translators + 5 seg generators.

Port of the inference half of deepliif_tpu/models/deepliif.py. The JAX
package stacks identical nets and vmaps them; here the translators (G) and
the seg generators (GS) are ``nn.ModuleList``s run in a Python loop, and
the seg aggregation is a tensordot with ``seg_weights``.

Public functions keep the JAX package's layout: x is (B, H, W, C) NHWC,
mods come back (M, B, H, W, C) and seg (B, H, W, C). The nets themselves
run NCHW in channels_last memory, which is the same bytes as NHWC, so the
boundary is a view.

Precision (``DeepLIIFDef.dtype`` / ``quant_int8``, from the model's
``precision`` option as in the JAX package): float32; bfloat16, where every
net runs in bf16 with float32 norm statistics; int8, which runs bf16
around int8 convs (``quantize_nets``: scope 'all', every conv with C_in
and C_out >= 16, or 'resblocks', the ResNet trunk's), with static scales
that ``calibrate_act_scales`` records or per-sample dynamic ones.
``DeepLIIFDef.fuse_stages`` (the model's
``fuse_stages`` option; bfloat16 only, raises otherwise) runs the
translators through their fused stages (``nets.resnet``), the counterpart
of the JAX package's ``DEEPLIIF_FUSE_STAGES=1``.

Not ported yet: ``seg_only_forward``, ``forward_with_branches`` (ROADMAP.md,
"Seg-only and intermediates") and training ("Training").
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import nets, roadmap
from ..nets import layers as L
from ..ops import quant


@dataclasses.dataclass(frozen=True)
class DeepLIIFDef:
    """Static model definition (the inference fields of the JAX DeepLIIFDef)."""
    modalities_no: int = 4
    seg_gen: bool = True
    input_nc: int = 3
    output_nc: int = 3
    input_no: int = 1
    ngf: int = 64
    net_g: tuple = ('resnet_9blocks',) * 4
    net_gs: tuple = ('unet_512',) * 5
    norm: str = 'batch'
    use_dropout: bool = True
    padding_type: str = 'zero'       # translation generators (cli default 'zero')
    upsample: str = 'convtranspose'
    seg_weights: tuple = (0.25, 0.15, 0.25, 0.1, 0.25)
    dtype: torch.dtype = torch.float32   # compute dtype of every net
    quant_int8: bool = False             # int8 trunk (--precision int8)
    fuse_stages: bool = False            # fused translator stages (bf16)


# compute dtype per --precision: int8 runs everything around the quantized
# trunk in bf16 (deepliif_tpu/models/deepliif.py def_from_opt)
PRECISIONS = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
              'int8': torch.bfloat16}


def def_from_opt(opt) -> DeepLIIFDef:
    m = opt.modalities_no
    net_g = getattr(opt, 'netG', getattr(opt, 'net_g', 'resnet_9blocks'))
    if isinstance(net_g, str):
        net_g = (net_g,) * m
    net_gs = getattr(opt, 'net_gs', 'unet_512')
    if isinstance(net_gs, str):
        net_gs = (net_gs,) * (m + 1)
    precision = getattr(opt, 'precision', 'float32') or 'float32'
    if precision not in PRECISIONS:
        raise ValueError(f'unknown precision [{precision}] (expected one '
                         f'of {sorted(PRECISIONS)})')
    return DeepLIIFDef(
        modalities_no=m,
        seg_gen=getattr(opt, 'seg_gen', True),
        input_nc=getattr(opt, 'input_nc', 3),
        output_nc=getattr(opt, 'output_nc', 3),
        input_no=getattr(opt, 'input_no', 1),
        ngf=getattr(opt, 'ngf', 64),
        net_g=tuple(net_g),
        net_gs=tuple(net_gs),
        norm=getattr(opt, 'norm', 'batch'),
        use_dropout=not getattr(opt, 'no_dropout', False),
        padding_type=getattr(opt, 'padding', 'zero'),
        upsample=getattr(opt, 'upsample', 'convtranspose'),
        seg_weights=tuple(getattr(opt, 'seg_weights',
                                  (0.25, 0.15, 0.25, 0.1, 0.25))),
        dtype=PRECISIONS[precision],
        quant_int8=precision == 'int8',
        fuse_stages=bool(getattr(opt, 'fuse_stages', False)),
    )


class DeepLIIFNets(nn.Module):
    """The generator ensemble: ``G[i]`` translators, ``GS[i]`` seg nets
    (``GS[0]`` consumes the input image, ``GS[i+1]`` translator i's output).
    Seg generators use define_G defaults: reflect padding, convtranspose
    (reference DeepLIIF_model.py:93-99). ``prefixes``: each net's JAX param
    path prefix ('G', or 'G/{i}' in a group of mixed architectures, which
    the JAX package keeps as a list), the keys of act_scales.json."""

    def __init__(self, d: DeepLIIFDef):
        super().__init__()
        self.prefixes = {
            group: [group if len(set(archs)) == 1 else f'{group}/{i}'
                    for i in range(len(archs))]
            for group, archs in (('G', d.net_g),
                                 ('GS', d.net_gs if d.seg_gen else ()))}
        cin = d.input_nc * d.input_no
        self.G = nn.ModuleList(
            nets.define_g(cin, d.output_nc, d.ngf, arch, d.norm, d.use_dropout,
                          d.padding_type, d.upsample)
            for arch in d.net_g)
        self.GS = nn.ModuleList(
            nets.define_g(cin, d.output_nc, d.ngf, arch, d.norm, d.use_dropout,
                          'reflect', 'convtranspose')
            for arch in (d.net_gs if d.seg_gen else ()))
        for net in list(self.G) + list(self.GS):
            net.compute_dtype = d.dtype
        if d.fuse_stages:
            nets.resnet.fused_stages_gate(d.dtype, d.quant_int8, 4 * d.ngf)
            for g in self.G:
                if not isinstance(g, nets.ResnetGenerator):
                    raise ValueError(f'fuse_stages needs ResNet translators, '
                                     f'got {type(g).__name__}')
                g.fuse_stages = True


def _groups(nets_):
    return (('G', nets_.G), ('GS', nets_.GS))


def quantizable_convs(nets_, min_ch=quant.MIN_CH):
    """{JAX key: [(net, conv name), ...]} of every conv the min_ch gate admits
    (the JAX package's ``_quantizable_conv_paths`` over the whole param
    tree: the keys calibration records and quantization reads). A group of
    one architecture shares its keys, as the JAX package stacks it."""
    out = {}
    for group, nets in _groups(nets_):
        for prefix, net in zip(nets_.prefixes[group], nets):
            for name, w, kind in net.conv_layout():
                cin, cout = (w.shape[1], w.shape[0]) if kind == 'conv' \
                    else (w.shape[0], w.shape[1])
                if cin >= min_ch and cout >= min_ch:
                    out.setdefault(f'{prefix}/{name}', []).append((net, name))
    return out


def quantize_nets(nets_, scope='all', act_scales=None):
    """int8: quantize every conv the min_ch gate admits within ``scope``
    ('all', or 'resblocks': the ResNet trunk's convs), the JAX package's
    ``quantize_conv_tree_int8``. ``act_scales``: the act_scales.json dict
    ({'G/down0_conv': max |x|, ...}, scalar or per input channel) or None;
    a conv with a scale runs static (the scale folded into its weights),
    one without runs per-sample dynamic scales."""
    pred = quant.int8_scope_predicate(scope)
    scales = {}
    for key, convs in quantizable_convs(nets_).items():
        if pred is None or pred(key):
            for net, name in convs:
                scales.setdefault(id(net), {})[name] = (act_scales or {}).get(
                    key)
    for _, nets in _groups(nets_):
        for net in nets:
            net.set_int8(scales.get(id(net), {}))


def calibrate_act_scales(nets_, x, d: DeepLIIFDef, min_ch=quant.MIN_CH,
                         out=None, per_channel=True, pct=100.0):
    """Per-conv input ranges over one normalized input batch x (B, H, W, C)
    for static int8 scales, the JAX package's ``calibrate_act_scales``:
    replays the ensemble on float weights in the compute dtype, one net at
    a time (the translators on their unfused trunk, which exposes every
    resblock conv's input; the seg nets on the input and the translators'
    outputs), recording each conv ``quantizable_convs`` admits
    (``layers.ActCalibration``: per input channel max |x|, or its ``pct``
    percentile; per tensor without ``per_channel``). Returns {'G/...':
    range, 'GS/...': ...}; pass the same ``out`` across batches to
    max-merge."""
    if nets_.training:
        raise roadmap.not_ported('training (call .eval())', roadmap.TRAINING)
    cal = L.ActCalibration(quantizable_convs(nets_, min_ch), out,
                           per_channel=per_channel, pct=pct)
    xc = x.to(d.dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        mods = [g.calibrate(xc, cal.at(prefix))
                for prefix, g in zip(nets_.prefixes['G'], nets_.G)]
        if d.seg_gen:
            seg_in = [xc] + [y.contiguous(memory_format=torch.channels_last)
                             for y in mods]
            for prefix, gs, xi in zip(nets_.prefixes['GS'], nets_.GS, seg_in):
                gs.calibrate(xi, cal.at(prefix))
    return cal.out


def generator_forward(nets_, x, d: DeepLIIFDef, *, seg_weights=None,
                      seg_gen=None):
    """Inference ensemble forward: x (B, H, W, C) -> (mods (M, B, H, W, C),
    seg (B, H, W, C) or None), in the compute dtype ``d.dtype`` (x is cast
    to it). ``seg_gen=False`` skips the seg branches."""
    if nets_.training:
        raise roadmap.not_ported('training (call .eval())', roadmap.TRAINING)
    seg_gen = d.seg_gen if seg_gen is None else seg_gen
    xc = x.to(d.dtype).permute(0, 3, 1, 2)   # NCHW view, channels_last memory
    mods = [g(xc) for g in nets_.G]
    mods_nhwc = torch.stack([y.permute(0, 2, 3, 1) for y in mods])
    if not seg_gen:
        return mods_nhwc, None
    w = torch.as_tensor(d.seg_weights if seg_weights is None else seg_weights,
                        dtype=torch.float32, device=x.device)
    # the seg nets take channels_last input, as GS[0] does: the fused
    # translator tail returns NCHW, and a bf16 seg net fed NCHW runs every
    # conv through cuDNN's NCHW <-> NHWC conversions (one small copy here
    # instead)
    mods_cl = [y.contiguous(memory_format=torch.channels_last) for y in mods]
    segs = torch.stack([gs(xi).permute(0, 2, 3, 1)
                        for gs, xi in zip(nets_.GS, [xc] + mods_cl)])
    seg = torch.tensordot(w.to(segs.dtype), segs, dims=1)
    return mods_nhwc, seg


def inference_forward(nets_, x, d: DeepLIIFDef, seg_weights=None,
                      seg_gen=None):
    """Inference entry: dict {'mods': (M, B, H, W, C), 'seg': (B, H, W, C)}."""
    mods, seg = generator_forward(nets_, x, d, seg_weights=seg_weights,
                                  seg_gen=seg_gen)
    out = {'mods': mods}
    if seg is not None:
        out['seg'] = seg
    return out
