"""Loss functions (functional), the port of deepliif_tpu/nets/losses.py.

Parity with the reference GANLoss / SmoothL1 / gradient penalty / TV loss
(reference networks.py:244-355, 746-755). Images and patch maps are NCHW,
so the channel axis, which the JAX package takes last, is 1 here.
"""

from __future__ import annotations

import torch


def _bce_with_logits(pred, target):
    # max(x, 0) - x t + log(1 + exp(-|x|)), the JAX package's form (and
    # its gradient at x == 0, 1/2 through the max)
    return (torch.maximum(pred, pred.new_zeros(())) - pred * target
            + torch.log1p(torch.exp(-pred.abs()))).mean()


def gan_loss(pred, target_is_real, gan_mode='vanilla', label_smoothing=0.0,
             real_label=1.0, fake_label=0.0, epsilon=1.0):
    """GAN objective against a constant label map, in float32.

    vanilla: BCE-with-logits; lsgan: MSE; wgangp: -/+ mean; poly_ce:
    BCE + eps (1 - pt), pt over the channel axis (reference
    networks.py:294-317)."""
    pred = pred.float()
    if gan_mode in ('vanilla', 'lsgan', 'poly_ce'):
        label = (real_label * (1.0 - label_smoothing) if target_is_real
                 else fake_label * label_smoothing)
        target = torch.full_like(pred, label)
    if gan_mode == 'lsgan':
        return ((pred - target) ** 2).mean()
    if gan_mode == 'vanilla':
        return _bce_with_logits(pred, target)
    if gan_mode == 'wgangp':
        return -pred.mean() if target_is_real else pred.mean()
    if gan_mode == 'poly_ce':
        pt = (target * torch.softmax(pred, dim=1)).sum(dim=1)
        return _bce_with_logits(pred, target) + epsilon * (1 - pt).mean()
    raise NotImplementedError(f'gan mode {gan_mode} not implemented')


def smooth_l1(pred, target, beta=1.0):
    """torch SmoothL1Loss (mean reduction), in float32."""
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def l1(pred, target):
    return (pred.float() - target.float()).abs().mean()


def total_variation(x):
    """Reference TotalVariationLoss (networks.py:746-755), NCHW input."""
    tv = ((x[:, :, 1:, :] - x[:, :, :-1, :]).abs().sum()
          + (x[:, :, :, 1:] - x[:, :, :, :-1]).abs().sum())
    return tv / x.numel()


def gradient_penalty(d_apply, real, fake, rng=None, gp_type='mixed',
                     constant=1.0, lambda_gp=10.0):
    """WGAN-GP gradient penalty (reference networks.py:320-354):
    ``d_apply`` maps images to patch maps; 'mixed' interpolates real and
    fake by a per-sample uniform alpha drawn from ``rng`` (a
    ``torch.Generator`` on the images' device). Differentiable (the input
    gradient is taken with ``create_graph``)."""
    if lambda_gp <= 0.0:
        return 0.0
    if gp_type == 'real':
        interp = real
    elif gp_type == 'fake':
        interp = fake
    else:
        alpha = torch.rand((real.shape[0], 1, 1, 1), generator=rng,
                           dtype=real.dtype, device=real.device)
        interp = alpha * real + (1 - alpha) * fake
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    grads, = torch.autograd.grad(d_apply(interp).sum(), interp,
                                 create_graph=True)
    grads = grads.reshape(real.shape[0], -1)
    norm = torch.sqrt(((grads + 1e-16) ** 2).sum(dim=1))
    return ((norm - constant) ** 2).mean() * lambda_gp


def kl_div_softmax(student_logits, teacher_logits, temperature=1.0):
    """KLDiv(log_softmax(student) || softmax(teacher)) over flattened
    outputs, batchmean-style (reference DeepLIIFKD_model.py:313-349)."""
    s = student_logits.reshape(student_logits.shape[0], -1) / temperature
    t = teacher_logits.reshape(teacher_logits.shape[0], -1) / temperature
    log_p = torch.log_softmax(s, dim=-1)
    q = torch.softmax(t, dim=-1)
    log_q = torch.log_softmax(t, dim=-1)
    return (q * (log_q - log_p)).sum(dim=-1).mean()
