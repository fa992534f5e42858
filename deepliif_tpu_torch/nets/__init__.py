"""Network factories mirroring deepliif_tpu.nets (reference define_G /
define_D): generators resnet_Nblocks, unet_32..unet_512 and
unet_512_attention, discriminators basic / n_layers / pixel, each an
``nn.Module`` in the reference layout; and the optimizers and
learning-rate schedules of training, with optax's semantics
(``nets.optim``)."""

from __future__ import annotations

from .att_unet import AttUnetGenerator
from .discriminators import NLayerDiscriminator, PixelDiscriminator
from .optim import make_lr_schedule, make_optimizer  # noqa: F401
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


def define_d(input_nc, ndf=64, net_d='n_layers', n_layers_d=3, norm='batch'):
    """Discriminator factory: basic (PatchGAN, n_layers 3) | n_layers |
    pixel."""
    if net_d == 'basic':
        net_d, n_layers_d = 'n_layers', 3
    if net_d == 'n_layers':
        return NLayerDiscriminator(input_nc, ndf, n_layers_d, norm)
    if net_d == 'pixel':
        return PixelDiscriminator(input_nc, ndf, norm)
    raise NotImplementedError(f'Discriminator [{net_d}] not recognized')
