"""DeepLIIFKD: knowledge distillation onto the DeepLIIF topology, the port of
deepliif_tpu/models/deepliif_kd.py.

The student is a DeepLIIF ensemble (``models.deepliif``: its nets, its
discriminators, its D loss and its validation losses); a frozen teacher,
loaded from a model dir (``load_teacher``), runs inside the G loss
through the port's inference forward (``deepliif.generator_forward`` in
eval mode, without gradients), so on a CUDA device its translators' trunk
runs the trunk kernel (``ops.fused_resblock.conv3x3_stats``) where its
gate admits it. The KD term is KLDiv(log_softmax(student) ||
softmax(teacher)) over each sample's flattened output (``kd_kl``), summed
over the M modalities, the M + 1 seg branches and the aggregated seg, x
``kd_factor`` (10). The JAX package's quirks are kept: the G side's GAN
criteria are vanilla (modalities) and lsgan (seg) whatever gan_mode
says, and the seg term is weighted by loss_G_weights[m - 1] (the
flagship's G loss uses [m]).
"""

from __future__ import annotations

import torch

from ..nets import losses, vgg
from . import deepliif as dl
from .deepliif import nchw


def kd_kl(student, teacher):
    """KLDivLoss(reduction='batchmean') of log_softmax(student) against
    softmax(teacher), each sample flattened, in float32: the per-sample
    sum, then the batch mean."""
    s = student.reshape(student.shape[0], -1).float()
    t = teacher.reshape(teacher.shape[0], -1).float()
    log_p = torch.log_softmax(s, dim=-1)
    q = torch.softmax(t, dim=-1)
    log_q = torch.log_softmax(t, dim=-1)
    return (q * (log_q - log_p)).sum(dim=-1).mean()


def load_teacher(model_dir_teacher, device='cpu'):
    """The frozen teacher (its nets in eval mode on ``device``, its
    ``DeepLIIFDef``) from a model dir: native npz files or a reference
    torch dir, through ``models.InferenceSession``'s loaders, at the
    precision its options name."""
    from . import InferenceSession
    session = InferenceSession(model_dir_teacher, device=device)
    if session.family != 'deepliif':
        raise ValueError(f'the teacher of DeepLIIFKD is a DeepLIIF model, '
                         f'got {session.model} in {model_dir_teacher}')
    session.nets.requires_grad_(False)
    return session.nets, session.d


def teacher_forward(teacher_nets, x, teacher_def):
    """The frozen teacher's (mods (M, B, H, W, C), seg (B, H, W, C), segs
    (M + 1, B, H, W, C)) on x (B, H, W, C), without gradients, as float32."""
    with torch.no_grad():
        mods, seg, segs = dl.generator_forward(teacher_nets, x, teacher_def,
                                               seg_gen=True, branches=True)
    return mods.float(), seg.float(), segs.float()


def student_forward_with_branches(nets_, x, d: dl.DeepLIIFDef, rng=None):
    """The student's train-mode forward: {'mods', 'seg', 'segs'}."""
    return dl.train_forward(nets_, x, d, rng, branches=True)


def g_loss_fn(nets_, batch, d: dl.DeepLIIFDef, vgg_net, teacher, rng=None,
              g_out=None, kd_factor=10.0):
    """The student's generator loss against the current discriminators and
    the teacher ``teacher`` ((nets, def)): (loss, (terms, g_out)); runs
    ``student_forward_with_branches`` unless ``g_out`` (its result) is
    given."""
    dt = dl.param_dtype(nets_)
    x = nchw(batch['A'].to(dt))
    if g_out is None:
        g_out = student_forward_with_branches(nets_, batch['A'], d, rng)
    t_mods, t_seg, t_segs = teacher_forward(teacher[0], batch['A'],
                                            teacher[1])
    m = d.modalities_no
    real_nhwc = batch['B_mods'].to(dt)
    real = [nchw(t) for t in real_nhwc]
    mods = [nchw(t) for t in g_out['mods']]
    w_g = dl.weights_like(d.loss_g_weights, x)
    l_gan = torch.stack([losses.gan_loss(p, True, 'vanilla')
                         for p in dl._d_preds(nets_.D, [x] * m, mods)])
    l_l1 = torch.stack([losses.smooth_l1(a, b) for a, b in zip(mods, real)]
                       ) * d.lambda_l1
    l_vgg = vgg.vgg_loss(vgg_net, nchw(g_out['mods']), nchw(real_nhwc)
                         ) * d.lambda_feat
    loss = ((l_gan + l_l1 + l_vgg) * w_g[:m]).sum()
    terms = {'G_GAN': l_gan, 'G_L1': l_l1, 'G_VGG': l_vgg}

    seg = nchw(g_out['seg'])
    l_gan_s = losses.gan_loss(dl._d_pred_seg(nets_.DS, x, real, seg, d),
                              True, 'lsgan')
    l_l1_s = losses.smooth_l1(seg, nchw(batch['B_seg'].to(dt))) * d.lambda_l1
    # the JAX package's quirk: the seg term weighted by loss_G_weights[m - 1]
    loss = loss + (l_gan_s + l_l1_s) * w_g[m - 1]
    terms.update(G_GAN_S=l_gan_s, G_L1_S=l_l1_s)

    kd = sum(kd_kl(a, b) for a, b in zip(g_out['mods'], t_mods))
    kd = kd + sum(kd_kl(a, b) for a, b in zip(g_out['segs'], t_segs))
    kd = kd + kd_kl(g_out['seg'], t_seg)
    loss = loss + kd * kd_factor
    terms['G_KD'] = kd
    return loss, (terms, g_out)


def def_from_opt(opt):
    """The student shares the DeepLIIF topology."""
    return dl.def_from_opt(opt)


def create_train_state(d, opt, steps_per_epoch=1, seed=0, device='cpu'):
    return dl.create_train_state(d, opt, steps_per_epoch, seed, device)


def make_train_step(d: dl.DeepLIIFDef, vgg_net, teacher):
    """step(state, batch, rng) -> (state, metrics, g_out {'mods', 'seg'}):
    the student's forward (with its seg branches) -> the DeepLIIF D loss
    on detached fakes -> D update -> the KD G loss against the updated
    discriminators and the teacher -> G update
    (``deepliif.alternating_step``)."""
    return dl.alternating_step(*dl.alternating_parts(
        student_forward_with_branches, dl.d_loss_fn, g_loss_fn, d,
        vgg_net=vgg_net, teacher=teacher), ('mods', 'seg'))
