"""SDG, inference: M translators on the channel concat of ``input_no``
input modalities, no seg.

Port of the inference half of deepliif_tpu/models/sdg.py. The engine
splits each image into ``input_no`` strips by width and concatenates their
tiles by channel (``models.inference``). The nets run in float32 at any
``precision``, as the JAX family definition does.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import roadmap
from . import family


@dataclasses.dataclass(frozen=True)
class SDGDef:
    """The inference fields of the JAX SDGDef."""
    modalities_no: int = 4
    input_no: int = 1
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    net_g: tuple = ('resnet_9blocks',) * 4
    norm: str = 'batch'
    use_dropout: bool = True
    padding_type: str = 'zero'
    upsample: str = 'convtranspose'
    dtype: torch.dtype = torch.float32
    quant_int8: bool = False
    fuse_stages: bool = False
    seg_gen: bool = False


def def_from_opt(opt) -> SDGDef:
    m = opt.modalities_no
    return SDGDef(
        modalities_no=m, input_no=getattr(opt, 'input_no', 1),
        ngf=getattr(opt, 'ngf', 64),
        net_g=family.archs(opt, 'netG', 'net_g', 'resnet_9blocks', m),
        norm=getattr(opt, 'norm', 'batch'),
        use_dropout=not getattr(opt, 'no_dropout', False),
        padding_type=getattr(opt, 'padding', 'zero'),
        upsample=getattr(opt, 'upsample', 'convtranspose'))


def make_nets(d: SDGDef):
    """G: the translators on input_nc * input_no channels (every one of
    the first architecture, as the JAX package builds them)."""
    return family.ModelNets(d, {'G': [
        (d.input_nc * d.input_no, d.net_g[0], d.padding_type, d.upsample)
    ] * d.modalities_no})


def generator_forward(nets_, x, d: SDGDef):
    """x (B, H, W, input_nc * input_no) -> (M, B, H, W, output_nc)."""
    if nets_.training:
        raise roadmap.not_ported('training (call .eval())', roadmap.TRAINING)
    xc = x.to(d.dtype).permute(0, 3, 1, 2)
    return torch.stack([g(xc).permute(0, 2, 3, 1) for g in nets_.G])
