"""Generator factory mirroring deepliif_tpu.nets.define_g (reference
define_G): resnet_Nblocks, unet_32..unet_512 and unet_512_attention.
Returns an ``nn.Module`` in the reference layout."""

from __future__ import annotations

from .att_unet import AttUnetGenerator
from .resnet import ResnetGenerator
from .unet import UnetGenerator

UNET_DOWNS = {32: 5, 64: 6, 128: 7, 256: 8, 512: 9}


def define_g(input_nc, output_nc, ngf=64, net_g='resnet_9blocks', norm='batch',
             use_dropout=True, padding_type='reflect', upsample='convtranspose'):
    if net_g.startswith('resnet_'):
        blocks_str = net_g.split('_')[1].replace('blocks', '')
        if not blocks_str.isdigit():
            raise NotImplementedError(f'Generator [{net_g}] not recognized')
        return ResnetGenerator(input_nc, output_nc, ngf, int(blocks_str), norm,
                               use_dropout, padding_type, upsample)
    if net_g == 'unet_512_attention':
        # fixed widths and batch norms, whatever ngf and norm say (as the
        # JAX package and the reference build it)
        return AttUnetGenerator(input_nc, output_nc)
    if net_g.startswith('unet_'):
        size = int(net_g.split('_')[1])
        return UnetGenerator(input_nc, output_nc, UNET_DOWNS[size], ngf, norm,
                             use_dropout)
    raise NotImplementedError(f'Generator [{net_g}] not recognized')
