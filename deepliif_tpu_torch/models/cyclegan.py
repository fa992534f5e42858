"""CycleGAN, inference: GA_i (A -> B) or, with ``BtoA``, GB_i (B -> A).

Port of the inference half of deepliif_tpu/models/cyclegan.py
(``inference_forward``). A model dir may hold one direction only; the
session loads the directions it finds. The nets run in float32 at any
``precision``, as the JAX family definition does.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import roadmap
from . import family


@dataclasses.dataclass(frozen=True)
class CycleGANDef:
    """The inference fields of the JAX CycleGANDef."""
    modalities_no: int = 1
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    net_g: tuple = ('resnet_9blocks',)
    norm: str = 'batch'
    use_dropout: bool = True
    padding_type: str = 'zero'
    upsample: str = 'convtranspose'
    dtype: torch.dtype = torch.float32
    quant_int8: bool = False
    fuse_stages: bool = False
    seg_gen: bool = False


def def_from_opt(opt) -> CycleGANDef:
    m = opt.modalities_no
    return CycleGANDef(
        modalities_no=m, ngf=getattr(opt, 'ngf', 64),
        net_g=family.archs(opt, 'netG', 'net_g', 'resnet_9blocks', m),
        norm=getattr(opt, 'norm', 'batch'),
        use_dropout=not getattr(opt, 'no_dropout', False),
        padding_type=getattr(opt, 'padding', 'zero'),
        upsample=getattr(opt, 'upsample', 'convtranspose'))


def make_nets(d: CycleGANDef, directions=('GA', 'GB')):
    """GA (input_nc -> output_nc) and GB (output_nc -> input_nc), the
    first architecture for every net; only ``directions``."""
    shapes = {'GA': (d.input_nc, d.output_nc), 'GB': (d.output_nc,
                                                      d.input_nc)}
    return family.ModelNets(d, {
        k: [(shapes[k][0], d.net_g[0], d.padding_type, d.upsample,
             shapes[k][1])] * d.modalities_no for k in directions})


def inference_forward(nets_, x, d: CycleGANDef, bto_a=False):
    """x (B, H, W, C) -> (M, B, H, W, C) through GB with ``bto_a``, else
    GA."""
    if nets_.training:
        raise roadmap.not_ported('training (call .eval())', roadmap.TRAINING)
    key = 'GB' if bto_a else 'GA'
    if key not in nets_.groups:
        raise FileNotFoundError(f'the model dir holds no {key}_* nets')
    xc = x.to(d.dtype).permute(0, 3, 1, 2)
    return torch.stack([g(xc).permute(0, 2, 3, 1)
                        for g in getattr(nets_, key)])
