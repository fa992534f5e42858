"""DeepLIIFExt, inference: M translators and M seg generators.

Port of the inference half of deepliif_tpu/models/deepliif_ext.py: the
translators G_i take the IHC image A; the seg net GS_i takes
concat(A, G_1(A), G_i(A)), 9 channels, with reflect padding. The nets run
in float32: the JAX family definition takes no compute dtype from the
``precision`` option, so a session at any precision computes this family
in float32, and with ``ModelNets`` the translators' trunk runs the float32
trunk kernel where the JAX gate admits it (batch norm, reflect or zero
padding).

Layouts as in ``models.deepliif``: x (B, H, W, C) NHWC, outputs (M, B, H,
W, C); the nets run NCHW in channels_last memory.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import roadmap
from . import family


@dataclasses.dataclass(frozen=True)
class DeepLIIFExtDef:
    """The inference fields of the JAX DeepLIIFExtDef."""
    modalities_no: int = 4
    seg_gen: bool = True
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    net_g: tuple = ('resnet_9blocks',) * 4
    net_gs: tuple = ('unet_512',) * 4
    norm: str = 'batch'
    use_dropout: bool = True
    padding_type: str = 'zero'
    dtype: torch.dtype = torch.float32
    quant_int8: bool = False
    fuse_stages: bool = False


def def_from_opt(opt) -> DeepLIIFExtDef:
    m = opt.modalities_no
    return DeepLIIFExtDef(
        modalities_no=m,
        seg_gen=getattr(opt, 'seg_gen', True),
        ngf=getattr(opt, 'ngf', 64),
        net_g=family.archs(opt, 'netG', 'net_g', 'resnet_9blocks', m),
        net_gs=family.archs(opt, 'net_gs', 'net_gs', 'unet_512', m),
        norm=getattr(opt, 'norm', 'batch'),
        use_dropout=not getattr(opt, 'no_dropout', False),
        padding_type=getattr(opt, 'padding', 'zero'))


def make_nets(d: DeepLIIFExtDef):
    """G: the translators (A -> B_i); GS: the seg nets on 9 channels; every
    net of a group the group's first architecture, as the JAX package
    builds them."""
    m = d.modalities_no
    groups = {'G': [(d.input_nc, d.net_g[0], d.padding_type,
                     'convtranspose')] * m}
    if d.seg_gen:
        groups['GS'] = [(d.input_nc * 3, d.net_gs[0], 'reflect',
                         'convtranspose')] * m
    return family.ModelNets(d, groups)


def generator_forward(nets_, x, d: DeepLIIFExtDef, seg_gen=None):
    """x (B, H, W, C) -> (mods (M, B, H, W, C), segs (M, B, H, W, C) or
    None); ``seg_gen=False`` skips the seg nets."""
    if nets_.training:
        raise roadmap.not_ported('training (call .eval())', roadmap.TRAINING)
    xc = x.to(d.dtype).permute(0, 3, 1, 2)
    mods = [g(xc) for g in nets_.G]
    mods_nhwc = torch.stack([y.permute(0, 2, 3, 1) for y in mods])
    if not (d.seg_gen if seg_gen is None else seg_gen):
        return mods_nhwc, None
    # GS_i input: concat(A, fake_B_1, fake_B_i) by channel, channels_last
    segs = [gs(torch.cat([xc, mods[0], y], 1).contiguous(
        memory_format=torch.channels_last))
        for gs, y in zip(nets_.GS, mods)]
    return mods_nhwc, torch.stack([y.permute(0, 2, 3, 1) for y in segs])
