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

The student trains at its own ``precision`` (bfloat16 as the flagship
does) and norm; the teacher runs at the precision of its own dir (the
JAX ``get_opt(model_dir_teacher, mode='test')``), so a bfloat16 teacher
runs the bfloat16 trunk kernel. With spectral norm the JAX step is kept
as it is: the D loss takes the fakes of the spectrally normalized
student, the G loss runs the student again on its raw weights (the JAX
``student_forward_with_branches`` normalizes nothing; the dropout masks
are the first forward's, ``raw_g_loss``), the discriminators are
normalized in both, and no ``spectral_u`` is refreshed.
"""

from __future__ import annotations

import torch

from ..nets import layers as L, losses, vgg
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
    (M + 1, B, H, W, C)) on x (B, H, W, C), without gradients, as float32.
    A spectrally normalized teacher's segs are its seg nets on the raw
    weights, as the JAX ``teacher_forward`` recomputes them (its mods and
    seg normalized)."""
    with torch.no_grad():
        mods, seg, segs = dl.generator_forward(teacher_nets, x, teacher_def,
                                               seg_gen=True, branches=True)
        if teacher_def.norm == 'spectral':
            xc = x.to(teacher_def.dtype).permute(0, 3, 1, 2)
            with L.raw_weights():
                segs = torch.stack([
                    gs(xi).permute(0, 2, 3, 1) for gs, xi in zip(
                        teacher_nets.GS, [xc] + [dl._seg_input(
                            y.permute(0, 3, 1, 2)) for y in mods])])
    return mods.float(), seg.float(), segs.float()


def student_forward_with_branches(nets_, x, d: dl.DeepLIIFDef, rng=None):
    """The student's train-mode forward: {'mods', 'seg', 'segs'}."""
    return dl.train_forward(nets_, x, d, rng, branches=True)


def g_loss_fn(nets_, batch, d: dl.DeepLIIFDef, vgg_net, teacher, rng=None,
              g_out=None, kd_factor=10.0):
    """The student's generator loss against the current discriminators and
    the teacher ``teacher`` ((nets, def)): (loss, (terms, g_out)); runs
    ``student_forward_with_branches`` on the raw weights (no spectral
    normalization, as the JAX G loss) unless ``g_out`` (its result) is
    given."""
    dt = dl.param_dtype(nets_)
    x = nchw(batch['A'].to(dt))
    if g_out is None:
        # the JAX G loss runs its student on the raw weights
        with L.raw_weights():
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
    (``deepliif.alternating_step``); with spectral norm the G loss runs
    the student again on its raw weights (``raw_g_loss``)."""
    forward, d_loss, g_loss = dl.alternating_parts(
        student_forward_with_branches, dl.d_loss_fn, g_loss_fn, d,
        vgg_net=vgg_net, teacher=teacher)
    if d.norm == 'spectral':
        forward, g_loss = raw_g_loss(forward, d, vgg_net, teacher)
    return dl.alternating_step(forward, d_loss, g_loss, ('mods', 'seg'))


def raw_g_loss(forward, d, vgg_net, teacher):
    """(forward, g_loss) of ``alternating_step`` where the G loss runs its
    own student forward on the raw weights (``g_loss_fn`` without
    ``g_out``), the JAX DeepLIIFKD step with spectral norm: the forward
    keeps its generator's state, and the G loss starts the generator from
    it again, so both draw the same dropout masks."""
    start = {}

    def fwd(nets_, batch, rng):
        start.update(rng=rng, state=None if rng is None else rng.get_state())
        return forward(nets_, batch, rng)

    def g_loss(nets_, batch, g_out):
        rng = start['rng']
        if rng is not None:
            rng.set_state(start['state'])
        loss, (terms, _) = g_loss_fn(nets_, batch, d, vgg_net, teacher, rng)
        return loss, terms
    return fwd, g_loss
