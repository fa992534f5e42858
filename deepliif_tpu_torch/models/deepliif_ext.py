"""DeepLIIFExt: M translators and M seg generators, and their training.

Port of deepliif_tpu/models/deepliif_ext.py: the
translators G_i take the IHC image A; the seg net GS_i takes
concat(A, G_1(A), G_i(A)), 9 channels, with reflect padding. The nets run
in float32: the JAX family definition takes no compute dtype from the
``precision`` option, so a session at any precision computes this family
in float32, and with ``ModelNets`` the translators' trunk runs the float32
trunk kernel where the JAX gate admits it (batch norm, reflect or zero
padding).

Layouts as in ``models.deepliif``: x (B, H, W, C) NHWC, outputs (M, B, H,
W, C); the nets run NCHW in channels_last memory.

Training (float32): ``make_nets(d, with_discriminators=True)`` adds D_i,
modality i's discriminator on concat(A, B_i) (6 channels), and DS_i, seg
net i's on concat(A, B_1, B_i, BS_i) (12 channels, the real modalities
for real and fake segs alike). The losses (``d_loss_fn``, ``g_loss_fn``):
GAN + SmoothL1 * lambda_L1 on the modalities (weights loss_G_weights /
loss_D_weights) and on the segs (uniform 1/M weights), no VGG term. The
JAX package's quirk is kept: the G side's seg GAN term uses ``gan_mode``,
the D side's ``gan_mode_s``. ``make_train_step`` runs the flagship's
order (``models.deepliif.make_train_step``) and reuses the forward for
both losses.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nets import losses
from . import deepliif as dl, family
from .deepliif import nchw, nhwc


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
    # training
    ndf: int = 64
    net_d: str = 'n_layers'
    net_ds: str = 'n_layers'
    n_layers_d: int = 4
    gan_mode: str = 'vanilla'
    gan_mode_s: str = 'lsgan'
    lambda_l1: float = 100.0
    loss_g_weights: tuple = (0.25,) * 4
    loss_d_weights: tuple = (0.25,) * 4
    init_type: str = 'normal'
    init_gain: float = 0.02

    @property
    def loss_gs_weights(self):
        return (1.0 / self.modalities_no,) * self.modalities_no


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
        padding_type=getattr(opt, 'padding', 'zero'),
        ndf=getattr(opt, 'ndf', 64),
        net_d=getattr(opt, 'netD', getattr(opt, 'net_d', 'n_layers')),
        net_ds=getattr(opt, 'net_ds', 'n_layers'),
        n_layers_d=getattr(opt, 'n_layers_D', 4),
        gan_mode=getattr(opt, 'gan_mode', 'vanilla'),
        gan_mode_s=getattr(opt, 'gan_mode_s', 'lsgan'),
        lambda_l1=float(getattr(opt, 'lambda_L1', 100.0)),
        loss_g_weights=tuple(getattr(opt, 'loss_G_weights', (1 / m,) * m)),
        loss_d_weights=tuple(getattr(opt, 'loss_D_weights', (1 / m,) * m)))


def make_nets(d: DeepLIIFExtDef, with_discriminators=False):
    """G: the translators (A -> B_i); GS: the seg nets on 9 channels; every
    net of a group the group's first architecture, as the JAX package
    builds them. ``with_discriminators``: D (6 channels) and, with seg
    nets, DS (12 channels)."""
    m = d.modalities_no
    groups = {'G': [(d.input_nc, d.net_g[0], d.padding_type,
                     'convtranspose')] * m}
    if d.seg_gen:
        groups['GS'] = [(d.input_nc * 3, d.net_gs[0], 'reflect',
                         'convtranspose')] * m
    disc = {}
    if with_discriminators:
        disc['D'] = [(d.input_nc + d.output_nc, d.net_d)] * m
        if d.seg_gen:
            disc['DS'] = [(d.input_nc * 3 + d.output_nc, d.net_ds)] * m
    return family.ModelNets(d, groups, disc)


def generator_forward(nets_, x, d: DeepLIIFExtDef, seg_gen=None):
    """x (B, H, W, C) -> (mods (M, B, H, W, C), segs (M, B, H, W, C) or
    None); ``seg_gen=False`` skips the seg nets."""
    dl.require_eval(nets_)
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


# ---------------------------------------------------------------------------
# training (deepliif_tpu/models/deepliif_ext.py :134-305)
# ---------------------------------------------------------------------------

def train_forward(nets_, x, d: DeepLIIFExtDef, rng=None):
    """The train-mode forward under autograd: x (B, H, W, C) -> {'mods':
    (M, B, H, W, C), 'segs': (M, B, H, W, C)} (no 'segs' without seg
    nets); dropout masks from ``rng`` (a ``torch.Generator`` on x's
    device), net after net. The seg nets take the translators' outputs
    with their gradient."""
    xc = nchw(x.to(dl.param_dtype(nets_)))
    mods = [g(xc, rng=rng) for g in nets_.G]
    out = {'mods': torch.stack([nhwc(y) for y in mods])}
    if d.seg_gen:
        out['segs'] = torch.stack([
            nhwc(gs(torch.cat([xc, mods[0], y], 1), rng=rng))
            for gs, y in zip(nets_.GS, mods)])
    return out


def _cond_seg(x, real):
    """real_concatenated: concat(A, real B_1, real B_i) by channel, one per
    modality (NCHW)."""
    return [torch.cat([x, real[0], r], 1) for r in real]


def _preds(ds, conds, imgs):
    return [dn(torch.cat([c, im], 1)) for dn, c, im in zip(ds, conds, imgs)]


def _gan(preds, real, mode):
    return torch.stack([losses.gan_loss(p, real, mode) for p in preds])


def d_loss_fn(nets_, g_out, batch, d: DeepLIIFExtDef):
    """The discriminator loss on detached fakes: (loss, terms)."""
    dt = dl.param_dtype(nets_)
    x = nchw(batch['A'].to(dt))
    real = [nchw(t.to(dt)) for t in batch['B_mods']]
    fake = [nchw(t).detach() for t in g_out['mods']]
    m = d.modalities_no
    lf = _gan(_preds(nets_.D, [x] * m, fake), False, d.gan_mode)
    lr = _gan(_preds(nets_.D, [x] * m, real), True, d.gan_mode)
    loss = ((lf + lr) * 0.5 * dl.weights_like(d.loss_d_weights, x)).sum()
    terms = {'D_fake': lf, 'D_real': lr}
    if d.seg_gen:
        cond = _cond_seg(x, real)
        fake_s = [nchw(t).detach() for t in g_out['segs']]
        real_s = [nchw(t.to(dt)) for t in batch['B_segs']]
        lfs = _gan(_preds(nets_.DS, cond, fake_s), False, d.gan_mode_s)
        lrs = _gan(_preds(nets_.DS, cond, real_s), True, d.gan_mode_s)
        loss = loss + ((lfs + lrs) * 0.5 * dl.weights_like(
            d.loss_gs_weights, x)).sum()
        terms.update(DS_fake=lfs, DS_real=lrs)
    return loss, terms


def g_loss_fn(nets_, batch, d: DeepLIIFExtDef, rng=None, g_out=None):
    """The generator loss against the current discriminators: (loss,
    (terms, g_out)); runs ``train_forward`` unless ``g_out`` is given. The
    seg GAN term uses ``gan_mode`` (the JAX package's quirk)."""
    dt = dl.param_dtype(nets_)
    x = nchw(batch['A'].to(dt))
    if g_out is None:
        g_out = train_forward(nets_, batch['A'], d, rng)
    real = [nchw(t.to(dt)) for t in batch['B_mods']]
    mods = [nchw(t) for t in g_out['mods']]
    m = d.modalities_no
    l_gan = _gan(_preds(nets_.D, [x] * m, mods), True, d.gan_mode)
    l_l1 = torch.stack([losses.smooth_l1(a, b) for a, b in zip(mods, real)]
                       ) * d.lambda_l1
    loss = ((l_gan + l_l1) * dl.weights_like(d.loss_g_weights, x)).sum()
    terms = {'G_GAN': l_gan, 'G_L1': l_l1}
    if d.seg_gen:
        segs = [nchw(t) for t in g_out['segs']]
        real_s = [nchw(t.to(dt)) for t in batch['B_segs']]
        l_gan_s = _gan(_preds(nets_.DS, _cond_seg(x, real), segs), True,
                       d.gan_mode)
        l_l1_s = torch.stack([losses.smooth_l1(a, b)
                              for a, b in zip(segs, real_s)]) * d.lambda_l1
        loss = loss + ((l_gan_s + l_l1_s) * dl.weights_like(
            d.loss_gs_weights, x)).sum()
        terms.update(GS_GAN=l_gan_s, GS_L1=l_l1_s)
    return loss, (terms, g_out)


def create_train_state(d: DeepLIIFExtDef, opt, steps_per_epoch=1, seed=0,
                       device='cpu'):
    return family.create_train_state(make_nets, d, opt, steps_per_epoch,
                                     seed, device)


def make_train_step(d: DeepLIIFExtDef, vgg_net=None):
    """step(state, batch, rng) -> (state, metrics, g_out), the flagship's
    order (``deepliif.alternating_step``); ``vgg_net`` is unused (no VGG
    term; the families' steps share one signature)."""
    return dl.alternating_step(*dl.alternating_parts(
        train_forward, d_loss_fn, g_loss_fn, d))


def make_eval_losses(d: DeepLIIFExtDef, vgg_net=None):
    """Validation losses without updates; no VGG term."""
    return dl.alternating_eval(*dl.alternating_parts(
        train_forward, d_loss_fn, g_loss_fn, d))
