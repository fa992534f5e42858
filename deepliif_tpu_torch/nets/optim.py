"""Optimizers and learning-rate schedules with optax's semantics on
``torch.optim`` (deepliif_tpu/nets/__init__.py :103-174; reference
networks.py:46-81).

torch's optimizers of the same names differ from optax's: AdamW decays by
1e-2 (optax 1e-4), RMSprop averages with alpha 0.99 and adds eps outside
the square root (optax: decay 0.9, eps inside), Adagrad starts its
accumulator at 0 with eps 1e-10 outside the root (optax: 0.1, 1e-7
inside). ``OptaxOptimizer`` computes optax's updates, in float32:

  adam     mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, count + 1,
           u = mu / (1 - b1^count) / (sqrt(nu / (1 - b2^count)) + 1e-8)
  adamw    u of adam + 1e-4 p
  sgd      u = g
  rmsprop  nu = 0.9 nu + 0.1 g^2, u = g / sqrt(nu + 1e-8)
  adagrad  s = s + g^2 (s from 0.1), u = g / sqrt(s + 1e-7) where s > 0

and p -= lr * schedule(count) * u, the schedule evaluated at the update
count before the update (optax's scale_by_schedule). Its state, per
parameter, is named as optax's (``mu``, ``nu``, ``sum_of_squares``), and
``count`` is the number of updates taken; ``utils.checkpoints`` writes it
in the JAX package's ``_optim.npz`` layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

B2, ADAM_EPS, ADAMW_DECAY = 0.999, 1e-8, 1e-4
RMS_DECAY, RMS_EPS = 0.9, 1e-8
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7

# the per-parameter state of each optimizer, by optax's names
MOMENTS = {'adam': ('mu', 'nu'), 'adamw': ('mu', 'nu'), 'sgd': (),
           'rmsprop': ('nu',), 'adagrad': ('sum_of_squares',)}


def make_lr_schedule(opt, steps_per_epoch=1):
    """Epoch-granular multiplier of the base learning rate, a function of
    the update count (epoch = count // steps_per_epoch). linear: flat for
    n_epochs, then linear decay to 0 over n_epochs_decay (+1 in the
    denominator, the reference lambda_rule, networks.py:68-72); step:
    0.1^(epoch // lr_decay_iters); cosine: (1 + cos(pi epoch /
    n_epochs)) / 2; plateau: 1 (the train loop's ``PlateauController``
    rescales the learning rate between epochs)."""
    policy = getattr(opt, 'lr_policy', 'linear')
    n_epochs = getattr(opt, 'n_epochs', 100)
    epoch_count = getattr(opt, 'epoch_count', 1)
    per = max(steps_per_epoch, 1)
    if policy == 'linear':
        n_decay = getattr(opt, 'n_epochs_decay', 100)
        return lambda step: 1.0 - max(
            0, step // per + epoch_count - n_epochs) / float(n_decay + 1)
    if policy == 'step':
        decay_iters = getattr(opt, 'lr_decay_iters', 50)
        return lambda step: 0.1 ** (step // per // decay_iters)
    if policy == 'cosine':
        return lambda step: 0.5 * (1 + math.cos(math.pi * (step // per)
                                                / n_epochs))
    if policy == 'plateau':
        return lambda step: 1.0
    raise NotImplementedError(f'lr policy [{policy}] not implemented')


def initial_moment(p, name):
    """The moment ``name`` of a tensor like ``p`` at optax's initial value
    (the adagrad accumulator ADAGRAD_INIT, every other 0)."""
    return torch.full_like(p, ADAGRAD_INIT if name == 'sum_of_squares'
                           else 0.0, memory_format=torch.preserve_format)


class OptaxOptimizer(torch.optim.Optimizer):
    """One of optax's adam, adamw, sgd, rmsprop, adagrad (``kind``) at
    base learning rate ``lr`` (each param group's 'lr'; the plateau
    controller rewrites it) times ``schedule(count)``."""

    def __init__(self, params, kind, lr, schedule=None, beta1=0.5):
        if kind not in MOMENTS:
            raise NotImplementedError(f'optimizer [{kind}] not implemented')
        super().__init__(params, {'lr': lr})
        self.kind = kind
        self.beta1 = beta1
        self.schedule = schedule or (lambda step: 1.0)
        self.count = 0

    def moment(self, p, name):
        """The state tensor ``name`` of parameter ``p`` (made at its initial
        value on first use)."""
        st = self.state[p]
        if name not in st:
            st[name] = initial_moment(p, name)
        return st[name]

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        mult = self.schedule(self.count)
        self.count += 1
        bc1 = float(f32(1) - f32(self.beta1) ** f32(self.count))
        bc2 = float(f32(1) - f32(B2) ** f32(self.count))
        for group in self.param_groups:
            lr = float(f32(group['lr'] * mult))
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                if self.kind in ('adam', 'adamw'):
                    mu, nu = self.moment(p, 'mu'), self.moment(p, 'nu')
                    mu.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
                    nu.mul_(B2).addcmul_(g, g, value=1 - B2)
                    u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                    if self.kind == 'adamw':
                        u = u + ADAMW_DECAY * p
                elif self.kind == 'sgd':
                    u = g
                elif self.kind == 'rmsprop':
                    nu = self.moment(p, 'nu')
                    nu.mul_(RMS_DECAY).addcmul_(g, g, value=1 - RMS_DECAY)
                    u = g * torch.rsqrt(nu + RMS_EPS)
                else:
                    s = self.moment(p, 'sum_of_squares')
                    s.addcmul_(g, g)
                    u = torch.where(s > 0, torch.rsqrt(s + ADAGRAD_EPS),
                                    torch.zeros_like(s)) * g
                p.add_(u, alpha=-lr)


def make_optimizer(opt, params, lr, steps_per_epoch=1):
    """The optimizer ``opt.optimizer`` (default adam, beta1 ``opt.beta1``)
    over ``params`` at base learning rate ``lr`` with the LR policy's
    schedule (``make_lr_schedule``)."""
    return OptaxOptimizer(params, getattr(opt, 'optimizer', 'adam').lower(),
                          lr, make_lr_schedule(opt, steps_per_epoch),
                          getattr(opt, 'beta1', 0.5))
