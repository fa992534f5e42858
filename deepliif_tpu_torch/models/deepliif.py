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
around an int8 ResNet trunk (``quantize_translators``, scope
``resblocks`` only). ``DeepLIIFDef.fuse_stages`` (the model's
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
    (reference DeepLIIF_model.py:93-99)."""

    def __init__(self, d: DeepLIIFDef):
        super().__init__()
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


def quantize_translators(nets_, act_scales=None):
    """int8 at scope 'resblocks': quantize the resblock convs of every
    translator (``ResnetGenerator.set_int8_trunk``); every other conv keeps
    the compute dtype. ``act_scales``: the JAX package's act_scales.json
    dict ({'G/res{i}_conv{j}': max |x|}, one vector shared by the
    translators of the stacked group) or None for dynamic scales."""
    for i, g in enumerate(nets_.G):
        if not isinstance(g, nets.ResnetGenerator):
            raise roadmap.not_ported(f'int8 translator {type(g).__name__} '
                                     '(the XLA int8 path)', roadmap.INT8_ALL)
        g.set_int8_trunk({k[len('G/'):]: v
                          for k, v in (act_scales or {}).items()
                          if k.startswith('G/')
                          and quant.int8_scope_predicate('resblocks')(k)})


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
