"""CycleGAN: GA_i (A -> B) or, with ``BtoA``, GB_i (B -> A); and its
training.

Port of deepliif_tpu/models/cyclegan.py. At inference
(``inference_forward``) a model dir may hold one direction only; the
session loads the directions it finds. The nets run in float32 at any
``precision``, as the JAX family definition does.

Training (float32), the JAX package's order: the G step (the four passes
of ``train_forward``, GAN + VGG + cycle L1 * lambda against the current
discriminators, then the G update), the image pools' query on the host
(``ImagePool``, a ring buffer of earlier fakes with a 50 % swap, drawn
from ``random.Random(seed)``; a copy of the JAX class), then the D step on
the pooled fakes (DA_i on B images, DB_i on A images), which alone counts
the step (the LR schedule reads it). Label smoothing scales the G side's
real target too, as the reference's shared criterion does.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from ..nets import losses, vgg
from . import deepliif as dl, family
from .deepliif import nchw, nhwc


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
    # training
    ndf: int = 64
    net_d: str = 'n_layers'
    n_layers_d: int = 4
    gan_mode: str = 'lsgan'
    label_smoothing: float = 0.0
    lambda_a: float = 10.0
    lambda_b: float = 10.0
    loss_g_weights: tuple = (1.0,)
    loss_d_weights: tuple = (1.0,)
    init_type: str = 'normal'
    init_gain: float = 0.02

    @property
    def loss_cyc_weights(self):
        return (1.0 / self.modalities_no,) * self.modalities_no


def def_from_opt(opt) -> CycleGANDef:
    m = opt.modalities_no
    return CycleGANDef(
        modalities_no=m, ngf=getattr(opt, 'ngf', 64),
        net_g=family.archs(opt, 'netG', 'net_g', 'resnet_9blocks', m),
        norm=getattr(opt, 'norm', 'batch'),
        use_dropout=not getattr(opt, 'no_dropout', False),
        padding_type=getattr(opt, 'padding', 'zero'),
        upsample=getattr(opt, 'upsample', 'convtranspose'),
        ndf=getattr(opt, 'ndf', 64),
        net_d=getattr(opt, 'netD', getattr(opt, 'net_d', 'n_layers')),
        n_layers_d=getattr(opt, 'n_layers_D', 4),
        gan_mode=getattr(opt, 'gan_mode', 'lsgan'),
        label_smoothing=float(getattr(opt, 'label_smoothing', 0.0)),
        loss_g_weights=tuple(getattr(opt, 'loss_G_weights', (1 / m,) * m)),
        loss_d_weights=tuple(getattr(opt, 'loss_D_weights', (1 / m,) * m)))


def make_nets(d: CycleGANDef, directions=('GA', 'GB'),
              with_discriminators=False):
    """GA (input_nc -> output_nc) and GB (output_nc -> input_nc), the
    first architecture for every net; only ``directions``.
    ``with_discriminators``: DA (on output_nc, B images) and DB (on
    input_nc, A images)."""
    m = d.modalities_no
    shapes = {'GA': (d.input_nc, d.output_nc), 'GB': (d.output_nc,
                                                      d.input_nc)}
    disc = {'DA': [(d.output_nc, d.net_d)] * m,
            'DB': [(d.input_nc, d.net_d)] * m} if with_discriminators \
        else None
    return family.ModelNets(d, {
        k: [(shapes[k][0], d.net_g[0], d.padding_type, d.upsample,
             shapes[k][1])] * m for k in directions}, disc)


def inference_forward(nets_, x, d: CycleGANDef, bto_a=False):
    """x (B, H, W, C) -> (M, B, H, W, C) through GB with ``bto_a``, else
    GA."""
    dl.require_eval(nets_)
    key = 'GB' if bto_a else 'GA'
    if key not in nets_.groups:
        raise FileNotFoundError(f'the model dir holds no {key}_* nets')
    xc = x.to(d.dtype).permute(0, 3, 1, 2)
    return torch.stack([g(xc).permute(0, 2, 3, 1)
                        for g in getattr(nets_, key)])


# ---------------------------------------------------------------------------
# training (deepliif_tpu/models/cyclegan.py :116-301)
# ---------------------------------------------------------------------------

class ImagePool:
    """History buffer with 50% swap (reference util/image_pool.py:5-54)."""

    def __init__(self, pool_size=50, seed=None):
        self.pool_size = pool_size
        self.images = []
        self.rng = random.Random(seed)

    def query(self, images):
        if self.pool_size == 0:
            return images
        images = np.asarray(images)
        out = []
        for img in images:
            if len(self.images) < self.pool_size:
                self.images.append(img.copy())
                out.append(img)
            elif self.rng.random() > 0.5:
                idx = self.rng.randint(0, self.pool_size - 1)
                out.append(self.images[idx].copy())
                self.images[idx] = img.copy()
            else:
                out.append(img)
        return np.stack(out)


def train_forward(nets_, real_as, real_bs, d: CycleGANDef, rng=None):
    """The four train-mode passes under autograd: real_as / real_bs (M, B,
    H, W, C) -> {'fake_bs': GA(real_as), 'rec_as': GB(fake_bs), 'fake_as':
    GB(real_bs), 'rec_bs': GA(fake_as)}, each (M, B, H, W, C); dropout
    masks from ``rng``, pass after pass, net after net."""
    dt = dl.param_dtype(nets_)

    def run(group, xs):
        return [g(x, rng=rng) for g, x in zip(group, xs)]
    fake_bs = run(nets_.GA, [nchw(t.to(dt)) for t in real_as])
    rec_as = run(nets_.GB, fake_bs)
    fake_as = run(nets_.GB, [nchw(t.to(dt)) for t in real_bs])
    rec_bs = run(nets_.GA, fake_as)
    return {k: torch.stack([nhwc(y) for y in v]) for k, v in (
        ('fake_bs', fake_bs), ('rec_as', rec_as), ('fake_as', fake_as),
        ('rec_bs', rec_bs))}


def g_loss_fn(nets_, real_as, real_bs, d: CycleGANDef, vgg_net, rng=None,
              outs=None):
    """The generator loss against the current discriminators: (loss,
    (terms, outs)); runs ``train_forward`` unless ``outs`` is given."""
    dt = dl.param_dtype(nets_)
    if outs is None:
        outs = train_forward(nets_, real_as, real_bs, d, rng)
    real_as, real_bs = real_as.to(dt), real_bs.to(dt)
    w_g = dl.weights_like(d.loss_g_weights, real_as)
    w_cyc = dl.weights_like(d.loss_cyc_weights, real_as)

    def gan_vgg(ds, fake, real):
        g = torch.stack([losses.gan_loss(dn(nchw(f)), True, d.gan_mode,
                                         d.label_smoothing)
                         for dn, f in zip(ds, fake)])
        return (g * w_g).sum() + (vgg.vgg_loss(vgg_net, nchw(fake),
                                               nchw(real)) * w_g).sum()

    def cycle(rec, real, lam):
        return (torch.stack([losses.l1(a, b) for a, b in zip(rec, real)])
                * lam * w_cyc).sum()
    loss_ga = gan_vgg(nets_.DA, outs['fake_bs'], real_bs)
    loss_gb = gan_vgg(nets_.DB, outs['fake_as'], real_as)
    cyc_a = cycle(outs['rec_as'], real_as, d.lambda_a)
    cyc_b = cycle(outs['rec_bs'], real_bs, d.lambda_b)
    terms = {'G_A': loss_ga, 'G_B': loss_gb, 'cycle_A': cyc_a,
             'cycle_B': cyc_b}
    return loss_ga + loss_gb + cyc_a + cyc_b, (terms, outs)


def d_loss_fn(nets_, pooled_fake_bs, pooled_fake_as, real_as, real_bs,
              d: CycleGANDef):
    """DA on real B images and the pooled fake ones, DB on real A images
    and the pooled fake ones (fakes detached): (loss, terms)."""
    dt = dl.param_dtype(nets_)
    w_d = dl.weights_like(d.loss_d_weights, real_as)

    def basic(ds, real, fake):
        lr = torch.stack([losses.gan_loss(dn(nchw(r.to(dt))), True,
                                          d.gan_mode, d.label_smoothing)
                          for dn, r in zip(ds, real)])
        lf = torch.stack([losses.gan_loss(dn(nchw(f.to(dt)).detach()), False,
                                          d.gan_mode, d.label_smoothing)
                          for dn, f in zip(ds, fake)])
        return ((lr + lf) * 0.5 * w_d).sum()
    loss_da = basic(nets_.DA, real_bs, pooled_fake_bs)
    loss_db = basic(nets_.DB, real_as, pooled_fake_as)
    return loss_da + loss_db, {'D_A': loss_da, 'D_B': loss_db}


def create_train_state(d: CycleGANDef, opt, steps_per_epoch=1, seed=0,
                       device='cpu'):
    return family.create_train_state(make_nets, d, opt, steps_per_epoch,
                                     seed, device)


def make_train_steps(d: CycleGANDef, vgg_net):
    """(g_step, d_step), the JAX package's two steps with the host pool
    query between them. g_step(state, real_as, real_bs, rng) -> (state,
    metrics, outs): G gradients against the current discriminators, the G
    update. d_step(state, pooled_fake_bs, pooled_fake_as, real_as,
    real_bs) -> (state, metrics): D gradients, the D update, step + 1.
    Gradients stay in each parameter's ``.grad``."""

    def g_step(state, real_as, real_bs, rng=None):
        g_loss, (terms, outs) = g_loss_fn(state.nets, real_as, real_bs, d,
                                          vgg_net, rng)
        dl.set_grads(state.g_params, g_loss)
        state.g_opt.step()
        return state, dl.detached({'loss_G': g_loss, **terms}), \
            dl.detached(outs)

    def d_step(state, pooled_fake_bs, pooled_fake_as, real_as, real_bs):
        d_loss, terms = d_loss_fn(state.nets, pooled_fake_bs,
                                  pooled_fake_as, real_as, real_bs, d)
        dl.set_grads(state.d_params, d_loss)
        state.d_opt.step()
        state.step += 1
        return state, dl.detached({'loss_D': d_loss, **terms})

    return g_step, d_step


def real_pair(batch, d: CycleGANDef):
    """A batch's (real_as (M, B, H, W, C): A for every modality, real_bs:
    its first M 'B_mods')."""
    m = d.modalities_no
    a = batch['A']
    return a[None].expand((m,) + tuple(a.shape)), batch['B_mods'][:m]


def make_eval_losses(d: CycleGANDef, vgg_net):
    """Validation losses without updates; the D losses on the current
    fakes (the pool is training-only history)."""

    def eval_losses(state, batch, rng=None):
        real_as, real_bs = real_pair(batch, d)
        with torch.no_grad():
            g_loss, (g_terms, outs) = g_loss_fn(state.nets, real_as,
                                                real_bs, d, vgg_net, rng)
            d_loss, d_terms = d_loss_fn(state.nets, outs['fake_bs'],
                                        outs['fake_as'], real_as, real_bs, d)
        return {'loss_G': g_loss, 'loss_D': d_loss, **g_terms, **d_terms}

    return eval_losses
