"""SDG: M translators on the channel concat of ``input_no`` input
modalities, no seg; and their training.

Port of deepliif_tpu/models/sdg.py. The engine splits each image into
``input_no`` strips by width and concatenates their tiles by channel
(``models.inference``). The nets run in float32 at any ``precision``, as
the JAX family definition does.

Training (float32): D_i, modality i's discriminator on concat(A, B_i)
(3 input_no + 3 channels); per modality GAN + SmoothL1 * lambda_L1 +
VGG * lambda_feat, weighted by loss_G_weights / loss_D_weights. A batch's
'B_mods' holds M + 1 tiles (the row's), of which the losses use the first
M, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nets import losses, vgg
from . import deepliif as dl, family
from .deepliif import nchw, nhwc


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
    # training
    ndf: int = 64
    net_d: str = 'n_layers'
    n_layers_d: int = 4
    gan_mode: str = 'vanilla'
    lambda_l1: float = 100.0
    lambda_feat: float = 100.0
    loss_g_weights: tuple = (0.25,) * 4
    loss_d_weights: tuple = (0.25,) * 4
    init_type: str = 'normal'
    init_gain: float = 0.02


def def_from_opt(opt) -> SDGDef:
    m = opt.modalities_no
    return SDGDef(
        modalities_no=m, input_no=getattr(opt, 'input_no', 1),
        ngf=getattr(opt, 'ngf', 64),
        net_g=family.archs(opt, 'netG', 'net_g', 'resnet_9blocks', m),
        norm=getattr(opt, 'norm', 'batch'),
        use_dropout=not getattr(opt, 'no_dropout', False),
        padding_type=getattr(opt, 'padding', 'zero'),
        upsample=getattr(opt, 'upsample', 'convtranspose'),
        ndf=getattr(opt, 'ndf', 64),
        net_d=getattr(opt, 'netD', getattr(opt, 'net_d', 'n_layers')),
        n_layers_d=getattr(opt, 'n_layers_D', 4),
        gan_mode=getattr(opt, 'gan_mode', 'vanilla'),
        lambda_l1=float(getattr(opt, 'lambda_L1', 100.0)),
        lambda_feat=float(getattr(opt, 'lambda_feat', 100.0)),
        loss_g_weights=tuple(getattr(opt, 'loss_G_weights', (1 / m,) * m)),
        loss_d_weights=tuple(getattr(opt, 'loss_D_weights', (1 / m,) * m)))


def make_nets(d: SDGDef, with_discriminators=False):
    """G: the translators on input_nc * input_no channels (every one of
    the first architecture, as the JAX package builds them);
    ``with_discriminators``: D on input_nc * input_no + output_nc."""
    m = d.modalities_no
    cin = d.input_nc * d.input_no
    disc = {'D': [(cin + d.output_nc, d.net_d)] * m} \
        if with_discriminators else None
    return family.ModelNets(d, {'G': [
        (cin, d.net_g[0], d.padding_type, d.upsample)] * m}, disc)


def generator_forward(nets_, x, d: SDGDef):
    """x (B, H, W, input_nc * input_no) -> (M, B, H, W, output_nc)."""
    dl.require_eval(nets_)
    xc = x.to(d.dtype).permute(0, 3, 1, 2)
    return torch.stack([g(xc).permute(0, 2, 3, 1) for g in nets_.G])


# ---------------------------------------------------------------------------
# training (deepliif_tpu/models/sdg.py :96-197)
# ---------------------------------------------------------------------------

def train_forward(nets_, x, d: SDGDef, rng=None):
    """The train-mode forward under autograd: x (B, H, W, input_nc *
    input_no) -> {'mods': (M, B, H, W, output_nc)}; dropout masks from
    ``rng``, net after net."""
    xc = nchw(x.to(dl.param_dtype(nets_)))
    return {'mods': torch.stack([nhwc(g(xc, rng=rng)) for g in nets_.G])}


def _preds(nets_, x, imgs):
    return [dn(torch.cat([x, im], 1)) for dn, im in zip(nets_.D, imgs)]


def d_loss_fn(nets_, g_out, batch, d: SDGDef):
    """The discriminator loss on detached fakes: (loss, terms)."""
    dt = dl.param_dtype(nets_)
    m = d.modalities_no
    x = nchw(batch['A'].to(dt))
    real = [nchw(t.to(dt)) for t in batch['B_mods'][:m]]
    fake = [nchw(t).detach() for t in g_out['mods']]
    lf = torch.stack([losses.gan_loss(p, False, d.gan_mode)
                      for p in _preds(nets_, x, fake)])
    lr = torch.stack([losses.gan_loss(p, True, d.gan_mode)
                      for p in _preds(nets_, x, real)])
    w = dl.weights_like(d.loss_d_weights, x)
    return ((lf + lr) * 0.5 * w).sum(), {'D_fake': lf, 'D_real': lr}


def g_loss_fn(nets_, batch, d: SDGDef, vgg_net, rng=None, g_out=None):
    """The generator loss against the current discriminators: (loss,
    (terms, g_out)); the VGG terms of the M modalities run as one batch of
    M B images."""
    dt = dl.param_dtype(nets_)
    m = d.modalities_no
    x = nchw(batch['A'].to(dt))
    if g_out is None:
        g_out = train_forward(nets_, batch['A'], d, rng)
    real_nhwc = batch['B_mods'][:m].to(dt)
    real = [nchw(t) for t in real_nhwc]
    mods = [nchw(t) for t in g_out['mods']]
    l_gan = torch.stack([losses.gan_loss(p, True, d.gan_mode)
                         for p in _preds(nets_, x, mods)])
    l_l1 = torch.stack([losses.smooth_l1(a, b) for a, b in zip(mods, real)]
                       ) * d.lambda_l1
    l_vgg = vgg.vgg_loss(vgg_net, nchw(g_out['mods']), nchw(real_nhwc)
                         ) * d.lambda_feat
    w = dl.weights_like(d.loss_g_weights, x)
    loss = ((l_gan + l_l1 + l_vgg) * w).sum()
    return loss, ({'G_GAN': l_gan, 'G_L1': l_l1, 'G_VGG': l_vgg}, g_out)


def create_train_state(d: SDGDef, opt, steps_per_epoch=1, seed=0,
                       device='cpu'):
    return family.create_train_state(make_nets, d, opt, steps_per_epoch,
                                     seed, device)


def make_train_step(d: SDGDef, vgg_net):
    """step(state, batch, rng) -> (state, metrics, g_out), the flagship's
    order (``deepliif.alternating_step``)."""
    return dl.alternating_step(*dl.alternating_parts(
        train_forward, d_loss_fn, g_loss_fn, d, vgg_net=vgg_net))


def make_eval_losses(d: SDGDef, vgg_net):
    """Validation losses without updates."""
    return dl.alternating_eval(*dl.alternating_parts(
        train_forward, d_loss_fn, g_loss_fn, d, vgg_net=vgg_net))
