"""DeepLIIF flagship model: 4 translators + 5 seg generators, and for
training 4 + 5 discriminators.

Port of deepliif_tpu/models/deepliif.py. The JAX package stacks identical
nets and vmaps them; here the translators (G), the seg generators (GS) and
the discriminators (D, DS) are ``nn.ModuleList``s run in a Python loop, and
the seg aggregation is a tensordot with ``seg_weights``.

Public functions keep the JAX package's layout: x is (B, H, W, C) NHWC,
mods come back (M, B, H, W, C) and seg (B, H, W, C). The nets themselves
run NCHW in channels_last memory, which is the same bytes as NHWC, so the
boundary is a view.

Precision (``DeepLIIFDef.dtype`` / ``quant_int8``, from the model's
``precision`` option as in the JAX package): float32; bfloat16, where every
net runs in bf16 with float32 norm statistics; int8, which runs bf16
around int8 convs (``quantize_nets``: scope 'all', every conv with C_in
and C_out >= 16, or 'resblocks', the ResNet trunk's), with static scales
that ``calibrate_act_scales`` records or per-sample dynamic ones.
``DeepLIIFDef.fuse_stages`` (the model's
``fuse_stages`` option; bfloat16 only, raises otherwise) runs the
translators through their fused stages (``nets.resnet``), the counterpart
of the JAX package's ``DEEPLIIF_FUSE_STAGES=1``.

``seg_only_forward`` runs only the translators and seg nets whose seg
weight is not zero (and the marker's translator), the reference's seg-only
pruning; ``forward_with_branches`` also returns each seg net's output (the
intermediates). ``norm='spectral'`` divides every conv weight by its
spectral norm (``layers.SpectralCache``, the JAX ``_maybe_spectral``).
At int8 with spectral norm the quantized convs take the raw weights and
their float route the normalized ones, as in the JAX package, which
quantizes its params at load and normalizes in the forward
(``layers.cast_function``).

Training (float32 or bfloat16, any norm; the JAX package's training
half, :156-195 and :478-680): ``init_nets`` draws every net with
discriminators from a ``torch.Generator`` (with spectral norm then every
conv's ``spectral_u``, the JAX ``add_spectral_u``), ``d_loss_fn`` /
``g_loss_fn`` are the losses of
backward_D / backward_G (GAN (modalities ``gan_mode``, seg ``gan_mode_s``)
+ SmoothL1 * lambda_L1 + VGG * lambda_feat on the modalities, GAN +
SmoothL1 on the seg), and ``make_train_step`` runs them in the JAX order:
the forward, the D loss on detached fakes, the D update, the G loss
against the updated discriminators, the G update. The forward is run
once and serves both losses (the JAX step recomputes it with the same
rng; without running statistics that is the same function). Fakes and
reals go through a discriminator in separate calls, each with its own
batch statistics. At bfloat16 every net, the discriminators included,
runs in bfloat16 with float32 parameters, statistics and losses (the JAX
``d.dtype``; the losses take the outputs with JAX's promotions: a float32
real beside a bfloat16 fake makes the discriminator's input float32
before its cast, the perceptual term runs the output's VGG features in
bfloat16 and the real's in float32). With spectral norm every conv's
weight is divided by its spectral norm in each forward
(``layers.train_cast``, the JAX ``_maybe_spectral``), and the step
refreshes every ``spectral_u`` after both updates (``make_train_step``).
``TrainState``, ``make_train_state``, ``set_grads`` and ``detached`` serve
the other families' training too (the JAX families share
``dl.TrainState``). int8 and the fused stages raise NotImplementedError
("Training").
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from .. import nets, parallel, roadmap
from ..nets import layers as L, losses, vgg
from ..ops import quant


@dataclasses.dataclass(frozen=True)
class DeepLIIFDef:
    """Static model definition (the inference fields of the JAX DeepLIIFDef)."""
    modalities_no: int = 4
    seg_gen: bool = True
    input_nc: int = 3
    output_nc: int = 3
    input_no: int = 1
    ngf: int = 64
    net_g: tuple = ('resnet_9blocks',) * 4
    net_gs: tuple = ('unet_512',) * 5
    norm: str = 'batch'
    use_dropout: bool = True
    padding_type: str = 'zero'       # translation generators (cli default 'zero')
    upsample: str = 'convtranspose'
    seg_weights: tuple = (0.25, 0.15, 0.25, 0.1, 0.25)
    dtype: torch.dtype = torch.float32   # compute dtype of every net
    quant_int8: bool = False             # int8 trunk (--precision int8)
    fuse_stages: bool = False            # fused translator stages (bf16)
    # training (the JAX DeepLIIFDef's other fields)
    ndf: int = 64
    net_d: str = 'n_layers'
    n_layers_d: int = 4
    gan_mode: str = 'vanilla'
    gan_mode_s: str = 'lsgan'
    lambda_l1: float = 100.0
    lambda_feat: float = 100.0
    loss_g_weights: tuple = (0.2,) * 5
    loss_d_weights: tuple = (0.2,) * 5
    init_type: str = 'normal'
    init_gain: float = 0.02

    @property
    def uniform_g(self):
        return len(set(self.net_g)) == 1

    @property
    def uniform_gs(self):
        return len(set(self.net_gs)) == 1


# compute dtype per --precision: int8 runs everything around the quantized
# trunk in bf16 (deepliif_tpu/models/deepliif.py def_from_opt)
PRECISIONS = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
              'int8': torch.bfloat16}


def def_from_opt(opt) -> DeepLIIFDef:
    m = opt.modalities_no
    net_g = getattr(opt, 'netG', getattr(opt, 'net_g', 'resnet_9blocks'))
    if isinstance(net_g, str):
        net_g = (net_g,) * m
    net_gs = getattr(opt, 'net_gs', 'unet_512')
    if isinstance(net_gs, str):
        net_gs = (net_gs,) * (m + 1)
    precision = getattr(opt, 'precision', 'float32') or 'float32'
    if precision not in PRECISIONS:
        raise ValueError(f'unknown precision [{precision}] (expected one '
                         f'of {sorted(PRECISIONS)})')
    return DeepLIIFDef(
        modalities_no=m,
        seg_gen=getattr(opt, 'seg_gen', True),
        input_nc=getattr(opt, 'input_nc', 3),
        output_nc=getattr(opt, 'output_nc', 3),
        input_no=getattr(opt, 'input_no', 1),
        ngf=getattr(opt, 'ngf', 64),
        net_g=tuple(net_g),
        net_gs=tuple(net_gs),
        norm=getattr(opt, 'norm', 'batch'),
        use_dropout=not getattr(opt, 'no_dropout', False),
        padding_type=getattr(opt, 'padding', 'zero'),
        upsample=getattr(opt, 'upsample', 'convtranspose'),
        seg_weights=tuple(getattr(opt, 'seg_weights',
                                  (0.25, 0.15, 0.25, 0.1, 0.25))),
        dtype=PRECISIONS[precision],
        quant_int8=precision == 'int8',
        fuse_stages=bool(getattr(opt, 'fuse_stages', False)),
        ndf=getattr(opt, 'ndf', 64),
        net_d=getattr(opt, 'netD', getattr(opt, 'net_d', 'n_layers')),
        n_layers_d=getattr(opt, 'n_layers_D', 4),
        gan_mode=getattr(opt, 'gan_mode', 'vanilla'),
        gan_mode_s=getattr(opt, 'gan_mode_s', 'lsgan'),
        lambda_l1=float(getattr(opt, 'lambda_L1', 100.0)),
        lambda_feat=float(getattr(opt, 'lambda_feat', 100.0)),
        loss_g_weights=tuple(getattr(opt, 'loss_G_weights', (0.2,) * (m + 1))),
        loss_d_weights=tuple(getattr(opt, 'loss_D_weights', (0.2,) * (m + 1))),
        init_type=getattr(opt, 'init_type', 'normal'),
        init_gain=getattr(opt, 'init_gain', 0.02),
    )


class DeepLIIFNets(nn.Module):
    """The generator ensemble: ``G[i]`` translators, ``GS[i]`` seg nets
    (``GS[0]`` consumes the input image, ``GS[i+1]`` translator i's output).
    Seg generators use define_G defaults: reflect padding, convtranspose
    (reference DeepLIIF_model.py:93-99). ``prefixes``: each net's JAX param
    path prefix ('G', or 'G/{i}' in a group of mixed architectures, which
    the JAX package keeps as a list), the keys of act_scales.json. With
    ``with_discriminators`` also ``D[i]``, modality i's discriminator on
    concat(input, modality), and ``DS[i]``, seg branch i's on
    concat(input or real modality i - 1, seg) (training)."""

    def __init__(self, d: DeepLIIFDef, with_discriminators=False):
        super().__init__()
        self.prefixes = {
            group: [group if len(set(archs)) == 1 else f'{group}/{i}'
                    for i in range(len(archs))]
            for group, archs in (('G', d.net_g),
                                 ('GS', d.net_gs if d.seg_gen else ()))}
        cin = d.input_nc * d.input_no
        self.G = nn.ModuleList(
            nets.define_g(cin, d.output_nc, d.ngf, arch, d.norm, d.use_dropout,
                          d.padding_type, d.upsample)
            for arch in d.net_g)
        self.GS = nn.ModuleList(
            nets.define_g(cin, d.output_nc, d.ngf, arch, d.norm, d.use_dropout,
                          'reflect', 'convtranspose')
            for arch in (d.net_gs if d.seg_gen else ()))
        for net in list(self.G) + list(self.GS):
            net.compute_dtype = d.dtype
            if d.norm == 'spectral':
                L.add_spectral_buffers(net)
        if d.fuse_stages:
            nets.resnet.fused_stages_gate(
                d.dtype, d.quant_int8, 4 * d.ngf,
                variant=(d.norm, d.padding_type, d.upsample))
            for g in self.G:
                if not isinstance(g, nets.ResnetGenerator):
                    raise ValueError(f'fuse_stages needs ResNet translators, '
                                     f'got {type(g).__name__}')
                g.fuse_stages = True
        self.with_discriminators = with_discriminators
        if with_discriminators:
            self.D = nn.ModuleList(_d_net(d) for _ in range(d.modalities_no))
            self.DS = nn.ModuleList(
                _d_net(d) for _ in range(d.modalities_no + 1 if d.seg_gen
                                         else 0))
            for net in list(self.D) + list(self.DS):
                net.compute_dtype = d.dtype
                if d.norm == 'spectral':
                    L.add_spectral_buffers(net)

    def named_groups(self):
        groups = [('G', self.G), ('GS', self.GS)]
        if self.with_discriminators:
            groups += [('D', self.D), ('DS', self.DS)]
        return groups


def _d_net(d: DeepLIIFDef):
    return nets.define_d(d.input_nc * d.input_no + d.output_nc, d.ndf,
                         d.net_d, d.n_layers_d, d.norm)


def quantizable_convs(nets_, min_ch=quant.MIN_CH):
    """{JAX key: [(net, conv name), ...]} of every conv the min_ch gate admits
    (the JAX package's ``_quantizable_conv_paths`` over the whole param
    tree: the keys calibration records and quantization reads). A group of
    one architecture shares its keys, as the JAX package stacks it."""
    out = {}
    for group, nets in nets_.named_groups():
        for prefix, net in zip(nets_.prefixes[group], nets):
            for name, w, kind in net.conv_layout():
                cin, cout = (w.shape[1], w.shape[0]) if kind == 'conv' \
                    else (w.shape[0], w.shape[1])
                if cin >= min_ch and cout >= min_ch:
                    out.setdefault(f'{prefix}/{name}', []).append((net, name))
    return out


def quantize_nets(nets_, scope='all', act_scales=None):
    """int8: quantize every conv the min_ch gate admits within ``scope``
    ('all', or 'resblocks': the ResNet trunk's convs), the JAX package's
    ``quantize_conv_tree_int8``. ``act_scales``: the act_scales.json dict
    ({'G/down0_conv': max |x|, ...}, scalar or per input channel) or None;
    a conv with a scale runs static (the scale folded into its weights),
    one without runs per-sample dynamic scales."""
    pred = quant.int8_scope_predicate(scope)
    scales = {}
    for key, convs in quantizable_convs(nets_).items():
        if pred is None or pred(key):
            for net, name in convs:
                scales.setdefault(id(net), {})[name] = (act_scales or {}).get(
                    key)
    for _, nets in nets_.named_groups():
        for net in nets:
            net.set_int8(scales.get(id(net), {}))


def calibrate_act_scales(nets_, x, d: DeepLIIFDef, min_ch=quant.MIN_CH,
                         out=None, per_channel=True, pct=100.0):
    """Per-conv input ranges over one normalized input batch x (B, H, W, C)
    for static int8 scales, the JAX package's ``calibrate_act_scales``:
    replays the ensemble on float weights in the compute dtype, one net at
    a time (the translators on their unfused trunk, which exposes every
    resblock conv's input; the seg nets on the input and the translators'
    outputs), recording each conv ``quantizable_convs`` admits
    (``layers.ActCalibration``: per input channel max |x|, or its ``pct``
    percentile; per tensor without ``per_channel``). Returns {'G/...':
    range, 'GS/...': ...}; pass the same ``out`` across batches to
    max-merge."""
    require_eval(nets_)
    cal = L.ActCalibration(quantizable_convs(nets_, min_ch), out,
                           per_channel=per_channel, pct=pct)
    xc = x.to(d.dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        mods = [g.calibrate(xc, cal.at(prefix))
                for prefix, g in zip(nets_.prefixes['G'], nets_.G)]
        if d.seg_gen:
            seg_in = [xc] + [y.contiguous(memory_format=torch.channels_last)
                             for y in mods]
            for prefix, gs, xi in zip(nets_.prefixes['GS'], nets_.GS, seg_in):
                gs.calibrate(xi, cal.at(prefix))
    return cal.out


def require_eval(nets_):
    """The inference forwards take nets in eval mode; a train-mode forward
    is the family's ``train_forward``."""
    if nets_.training:
        raise ValueError('an inference forward needs the nets in eval mode '
                         '(call .eval()); training runs train_forward')


@functools.lru_cache(maxsize=64)
def _weights_on(w, device):
    """The weights ``w`` (a tuple) as a float32 tensor on ``device``, made
    once: a tensor made from host values on a CUDA device waits for the
    device's stream."""
    return torch.tensor(w, dtype=torch.float32, device=device)


def _seg_sum(w, segs):
    """The weighted seg sum over the branch axis, one tensordot (a BLAS
    call, so through the engine's batch hook, ``layers.batch_call``): a
    branch of weight 0 given as zeros leaves the sum's bits as they
    are."""
    w = _weights_on(tuple(float(v) for v in w), segs.device).to(segs.dtype)
    return L.batch_call(lambda t: torch.tensordot(w, t, dims=1), segs,
                        ('tensordot', len(w), tuple(segs.shape[2:]),
                         segs.dtype), axis=1)


def _seg_input(y):
    # the seg nets take channels_last input, as GS[0] does: the fused
    # translator tail returns NCHW, and a bf16 seg net fed NCHW runs every
    # conv through cuDNN's NCHW <-> NHWC conversions (one small copy here
    # instead)
    return y.contiguous(memory_format=torch.channels_last)


def generator_forward(nets_, x, d: DeepLIIFDef, *, seg_weights=None,
                      seg_gen=None, branches=False):
    """Inference ensemble forward: x (B, H, W, C) -> (mods (M, B, H, W, C),
    seg (B, H, W, C) or None), in the compute dtype ``d.dtype`` (x is cast
    to it). ``seg_gen=False`` skips the seg branches; ``branches`` also
    returns the seg nets' outputs (M + 1, B, H, W, C)."""
    require_eval(nets_)
    seg_gen = d.seg_gen if seg_gen is None else seg_gen
    xc = x.to(d.dtype).permute(0, 3, 1, 2)   # NCHW view, channels_last memory
    mods = [g(xc) for g in nets_.G]
    mods_nhwc = torch.stack([y.permute(0, 2, 3, 1) for y in mods])
    if not seg_gen:
        return (mods_nhwc, None, None) if branches else (mods_nhwc, None)
    segs = torch.stack([gs(xi).permute(0, 2, 3, 1) for gs, xi in
                        zip(nets_.GS, [xc] + [_seg_input(y) for y in mods])])
    seg = _seg_sum(d.seg_weights if seg_weights is None else seg_weights,
                   segs)
    return (mods_nhwc, seg, segs) if branches else (mods_nhwc, seg)


def forward_with_branches(nets_, x, d: DeepLIIFDef, seg_weights=None):
    """``generator_forward`` with the seg nets' outputs: (mods, seg, segs
    (M + 1, B, H, W, C)), the JAX package's ``forward_with_branches`` (the
    reference's return_seg_intermediate)."""
    return generator_forward(nets_, x, d, seg_weights=seg_weights,
                             seg_gen=True, branches=True)


def seg_only_forward(nets_, x, d: DeepLIIFDef, seg_weights=None,
                     marker_index=None):
    """The seg alone (the JAX package's ``seg_only_forward``, the
    reference's seg-only pruning): only the translators whose seg branch
    has a weight other than 0, and the marker translator ``marker_index``
    when given, then only the seg nets of weight other than 0. Returns
    (seg (B, H, W, C), the marker modality (B, H, W, C) or None). With the
    legacy weights (0.5, 0, 0, 0, 0.5) that is 1 translator and 2 seg nets
    of 4 + 5. The pruned branches enter the weighted sum as zeros, so the
    seg has the full forward's bits."""
    require_eval(nets_)
    w = tuple(float(v) for v in (d.seg_weights if seg_weights is None
                                 else seg_weights))
    needed = [i for i in range(d.modalities_no) if w[i + 1] != 0]
    run = sorted(set(needed) | ({marker_index} if marker_index is not None
                                else set()))
    xc = x.to(d.dtype).permute(0, 3, 1, 2)
    mods = {i: nets_.G[i](xc) for i in run}
    inputs = {0: xc, **{i + 1: _seg_input(mods[i]) for i in needed}}
    segs = {gi: nets_.GS[gi](inputs[gi]).permute(0, 2, 3, 1)
            for gi in ([0] if w[0] != 0 else []) + [i + 1 for i in needed]}
    if segs:
        zero = torch.zeros_like(next(iter(segs.values())))
        seg = _seg_sum(w, torch.stack([segs.get(i, zero)
                                       for i in range(len(w))]))
    else:
        seg = torch.zeros_like(x)
    marker = None if marker_index is None else \
        mods[marker_index].permute(0, 2, 3, 1)
    return seg, marker


def inference_forward(nets_, x, d: DeepLIIFDef, seg_weights=None,
                      seg_gen=None, return_intermediate=False):
    """Inference entry: dict {'mods': (M, B, H, W, C), 'seg': (B, H, W, C)}
    (+ 'segs': (M + 1, B, H, W, C), each seg net's output, with
    ``return_intermediate`` where every translator and every seg net share
    one architecture, as in the JAX package)."""
    seg_gen = d.seg_gen if seg_gen is None else seg_gen
    if return_intermediate and seg_gen and d.uniform_g and d.uniform_gs:
        mods, seg, segs = forward_with_branches(nets_, x, d,
                                                seg_weights=seg_weights)
        return {'mods': mods, 'seg': seg, 'segs': segs}
    mods, seg = generator_forward(nets_, x, d, seg_weights=seg_weights,
                                  seg_gen=seg_gen)
    out = {'mods': mods}
    if seg is not None:
        out['seg'] = seg
    return out


# ---------------------------------------------------------------------------
# training (deepliif_tpu/models/deepliif.py :478-680)
# ---------------------------------------------------------------------------

def unset(make):
    """The modules ``make()`` builds, on the CPU with their tensors
    allocated but not set: built on the meta device, so torch's default
    init of every conv (443 M parameters in the full-width flagship with
    its discriminators) is skipped, for a caller that draws every
    parameter and buffer itself (``init_nets``)."""
    with torch.device('meta'):
        nets_ = make()
    return nets_.to_empty(device='cpu')


def init_nets(d: DeepLIIFDef, generator=None, with_discriminators=True):
    """Every net of ``d`` (the discriminators with
    ``with_discriminators``), on the CPU, initialized by ``d.init_type`` /
    ``d.init_gain`` from ``generator`` (``layers.init_net``), then, with
    spectral norm, every conv's ``spectral_u`` from N(0, 1), group after
    group (``layers.draw_spectral_u``): the counterpart of the JAX
    ``init_params``, whose ``add_spectral_u`` draws u for the G, GS, D and
    DS groups."""
    if d.quant_int8 or d.fuse_stages:
        raise roadmap.not_ported('training at int8 or with the fused '
                                 'stages', roadmap.TRAINING)
    nets_ = unset(lambda: DeepLIIFNets(d, with_discriminators))
    groups = [g for _, g in nets_.named_groups()]
    for group in groups:
        for net in group:
            L.init_net(net, d.init_type, d.init_gain, generator)
    if d.norm == 'spectral':
        for group in groups:
            for net in group:
                L.draw_spectral_u(net, generator)
    return nets_


def param_dtype(nets_):
    """The nets' parameter dtype: float32 in training (float64 where a
    test or check makes a float64 reference on the CPU)."""
    return next(nets_.parameters()).dtype



def nchw(t):
    """(..., H, W, C) -> (..., C, H, W), a view."""
    return t.movedim(-1, -3)


def train_forward(nets_, x, d: DeepLIIFDef, rng=None, branches=False):
    """The train-mode ensemble forward under autograd: x (B, H, W, C) ->
    {'mods': (M, B, H, W, C), 'seg': (B, H, W, C)} (no 'seg' without seg
    generators; with ``branches`` also 'segs', each seg net's output (M +
    1, B, H, W, C)), in the nets' train dtype (``layers.train_dtype``:
    ``d.dtype`` at bfloat16, else the parameters'); dropout masks drawn
    from ``rng`` (a ``torch.Generator`` on x's device), net after net. The
    seg nets take the translators' outputs with their gradient."""
    xc = nchw(x.to(L.train_dtype(nets_.G[0])))
    mods = [g(xc, rng=rng) for g in nets_.G]
    out = {'mods': torch.stack([nhwc(y) for y in mods])}
    if d.seg_gen:
        segs = torch.stack([gs(xi, rng=rng) for gs, xi in
                            zip(nets_.GS, [xc] + mods)])
        out['seg'] = nhwc(_seg_sum(d.seg_weights, segs))
        if branches:
            out['segs'] = segs.permute(0, 1, 3, 4, 2)
    return out


def nhwc(y):
    """(B, C, H, W) -> (B, H, W, C), a view."""
    return y.permute(0, 2, 3, 1)


def _d_preds(ds, conds, imgs):
    """Discriminator i on concat(conds[i], imgs[i]), one call each."""
    return [dn(torch.cat([c, im], dim=1)) for dn, c, im in zip(ds, conds,
                                                              imgs)]


def _d_pred_seg(ds, x, real_mods, seg, d: DeepLIIFDef):
    """Seg discriminators: DS[0] conditioned on x, DS[i] on real modality
    i - 1; the prediction of the loss is the seg-weighted sum of the patch
    maps (DeepLIIF_model.py:249-262)."""
    conds = [x] + real_mods
    return _seg_sum(d.seg_weights, torch.stack(
        _d_preds(ds, conds, [seg] * len(conds))))


def weights_like(w, like):
    return torch.as_tensor(w, dtype=torch.float32, device=like.device)


def d_loss_fn(nets_, g_out, batch, d: DeepLIIFDef):
    """The discriminator loss on detached fakes: (loss, terms). ``batch``:
    {'A': (B, H, W, C), 'B_mods': (M, B, H, W, C), 'B_seg': (B, H, W, C)}
    tensors; ``g_out`` as ``train_forward`` returns it."""
    dt = param_dtype(nets_)
    x = nchw(batch['A'].to(dt))
    real = [nchw(t.to(dt)) for t in batch['B_mods']]
    fake = [nchw(t).detach() for t in g_out['mods']]
    m = d.modalities_no
    w_d = weights_like(d.loss_d_weights, x)
    lf = torch.stack([losses.gan_loss(p, False, d.gan_mode)
                      for p in _d_preds(nets_.D, [x] * m, fake)])
    lr = torch.stack([losses.gan_loss(p, True, d.gan_mode)
                      for p in _d_preds(nets_.D, [x] * m, real)])
    loss = ((lf + lr) * 0.5 * w_d[:m]).sum()
    terms = {'D_fake': lf, 'D_real': lr}
    if d.seg_gen:
        fake_seg = nchw(g_out['seg']).detach()
        real_seg = nchw(batch['B_seg'].to(dt))
        lfs = losses.gan_loss(_d_pred_seg(nets_.DS, x, real, fake_seg, d),
                              False, d.gan_mode_s)
        lrs = losses.gan_loss(_d_pred_seg(nets_.DS, x, real, real_seg, d),
                              True, d.gan_mode_s)
        loss = loss + (lfs + lrs) * 0.5 * w_d[m]
        terms.update(D_fake_S=lfs, D_real_S=lrs)
    return loss, terms


def g_loss_fn(nets_, batch, d: DeepLIIFDef, vgg_net, rng=None, g_out=None):
    """The generator loss against the current discriminators: (loss,
    (terms, g_out)); runs ``train_forward`` unless ``g_out`` (its result)
    is given. The VGG terms of the M modalities run as one batch of M B
    images."""
    dt = param_dtype(nets_)
    x = nchw(batch['A'].to(dt))
    if g_out is None:
        g_out = train_forward(nets_, batch['A'], d, rng)
    real_nhwc = batch['B_mods'].to(dt)
    real = [nchw(t) for t in real_nhwc]
    mods = [nchw(t) for t in g_out['mods']]
    m = d.modalities_no
    w_g = weights_like(d.loss_g_weights, x)
    l_gan = torch.stack([losses.gan_loss(p, True, d.gan_mode)
                         for p in _d_preds(nets_.D, [x] * m, mods)])
    l_l1 = torch.stack([losses.smooth_l1(a, b) for a, b in zip(mods, real)]
                       ) * d.lambda_l1
    l_vgg = vgg.vgg_loss(vgg_net, nchw(g_out['mods']),
                         nchw(real_nhwc)) * d.lambda_feat
    loss = ((l_gan + l_l1 + l_vgg) * w_g[:m]).sum()
    terms = {'G_GAN': l_gan, 'G_L1': l_l1, 'G_VGG': l_vgg}
    if d.seg_gen:
        seg = nchw(g_out['seg'])
        real_seg = nchw(batch['B_seg'].to(dt))
        l_gan_s = losses.gan_loss(_d_pred_seg(nets_.DS, x, real, seg, d),
                                  True, d.gan_mode_s)
        l_l1_s = losses.smooth_l1(seg, real_seg) * d.lambda_l1
        loss = loss + (l_gan_s + l_l1_s) * w_g[m]
        terms.update(G_GAN_S=l_gan_s, G_L1_S=l_l1_s)
    return loss, (terms, g_out)


def is_discriminator_group(name):
    """A net group of the discriminators (D, DS, DA, DB) rather than of the
    generators (G, GS, GA, GB): the JAX package's d_params / g_params."""
    return name.startswith('D')


class TrainState:
    """The nets (generators and discriminators, in train mode; any module
    with ``named_groups()``: ``DeepLIIFNets`` or a family's
    ``family.ModelNets``), their two optimizers
    (``nets.optim.OptaxOptimizer``) and the step count."""

    def __init__(self, nets_, g_opt, d_opt, step=0):
        self.nets, self.g_opt, self.d_opt, self.step = nets_, g_opt, d_opt, step

    def groups(self, discriminators):
        """[(name, nets)] of the discriminator or generator groups that
        hold nets."""
        return [(name, group) for name, group in self.nets.named_groups()
                if is_discriminator_group(name) == discriminators
                and len(group)]

    @property
    def g_params(self):
        return [p for _, g in self.groups(False) for p in g.parameters()]

    @property
    def d_params(self):
        return [p for _, g in self.groups(True) for p in g.parameters()]


def make_train_state(nets_, opt, steps_per_epoch=1, device='cpu'):
    """``nets_`` (with discriminators) moved to ``device`` in train mode, and
    the G and D optimizers over the generator and discriminator groups
    (``opt.optimizer`` at ``opt.lr_g`` / ``opt.lr_d`` with
    ``opt.lr_policy``'s schedule), the JAX families' shared
    ``create_train_state``."""
    nets_ = nets_.to(device).train()
    state = TrainState(nets_, None, None)
    state.g_opt = nets.make_optimizer(opt, state.g_params,
                                      getattr(opt, 'lr_g', 2e-4),
                                      steps_per_epoch)
    state.d_opt = nets.make_optimizer(opt, state.d_params,
                                      getattr(opt, 'lr_d', 2e-4),
                                      steps_per_epoch)
    return state


def create_train_state(d: DeepLIIFDef, opt, steps_per_epoch=1, seed=0,
                       device='cpu'):
    """Nets drawn from a generator seeded ``seed`` (on the CPU, so every
    device gets the same weights), moved to ``device`` in train mode, and
    their optimizers (``make_train_state``)."""
    return make_train_state(init_nets(d, torch.Generator().manual_seed(seed)),
                            opt, steps_per_epoch, device)


def set_grads(params, loss):
    """p.grad = d loss / d p for every p (zeros where p does not reach the
    loss, as JAX's grad gives); under data parallelism then the mean over
    ranks (``parallel.all_reduce_grads``: the gradient of the global
    batch's loss, each rank's loss a mean over its equal shard)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    parallel.all_reduce_grads(params)


def detached(metrics):
    return {k: v.detach() for k, v in metrics.items()}


def alternating_step(forward, d_loss, g_loss, out_keys=None):
    """The alternating update (reference optimize_parameters,
    DeepLIIF_model.py:431-467), for any family whose losses share one
    forward: ``forward(nets, batch, rng)`` -> g_out, D gradients of
    ``d_loss(nets, g_out, batch)`` -> (loss, terms) on detached fakes, the
    D update, G gradients of ``g_loss(nets, batch, g_out)`` -> (loss,
    terms) against the updated discriminators, the G update, its CUDA
    convs one call each (``layers.batched``). Returns step(state, batch,
    rng) -> (state, metrics, g_out (its ``out_keys``, default all),
    detached); the gradients stay in each parameter's ``.grad``."""

    def step(state, batch, rng=None):
        with L.batched():
            g_out = forward(state.nets, batch, rng)
            loss_d, d_terms = d_loss(state.nets, g_out, batch)
            set_grads(state.d_params, loss_d)
            state.d_opt.step()
            loss_g, g_terms = g_loss(state.nets, batch, g_out)
            set_grads(state.g_params, loss_g)
            state.g_opt.step()
        state.step += 1
        metrics = detached({'loss_G': loss_g, 'loss_D': loss_d, **g_terms,
                            **d_terms})
        return state, metrics, detached(
            {k: g_out[k] for k in (out_keys or g_out)})

    return step


def alternating_eval(forward, d_loss, g_loss):
    """Validation losses without updates (reference calculate_losses,
    DeepLIIF_model.py:469-507, family-generic): the train-mode forward and
    both losses of ``alternating_step``'s functions, without gradients."""

    def eval_losses(state, batch, rng=None):
        with torch.no_grad(), L.batched():
            g_out = forward(state.nets, batch, rng)
            loss_d, d_terms = d_loss(state.nets, g_out, batch)
            loss_g, g_terms = g_loss(state.nets, batch, g_out)
        return {'loss_G': loss_g, 'loss_D': loss_d, **g_terms, **d_terms}

    return eval_losses


def alternating_parts(forward_fn, d_loss_fn_, g_loss_fn_, d, **extra):
    """(forward, d_loss, g_loss) of ``alternating_step`` from a family's
    ``forward_fn(nets, x, d, rng)``, ``d_loss_fn_(nets, g_out, batch, d)``
    and ``g_loss_fn_(nets, batch, d, **extra, g_out=...)`` -> (loss,
    (terms, g_out)); ``extra`` holds what the G loss needs beyond the
    batch (``vgg_net``, DeepLIIFKD's ``teacher``)."""
    def forward(nets_, batch, rng):
        return forward_fn(nets_, batch['A'], d, rng)

    def d_loss(nets_, g_out, batch):
        return d_loss_fn_(nets_, g_out, batch, d)

    def g_loss(nets_, batch, g_out):
        loss, (terms, _) = g_loss_fn_(nets_, batch, d, g_out=g_out, **extra)
        return loss, terms
    return forward, d_loss, g_loss


def refresh_spectral(nets_):
    """Every ``spectral_u`` of every net refreshed from the current
    weights (``layers.refresh_spectral_u``)."""
    for _, group in nets_.named_groups():
        for net in group:
            L.refresh_spectral_u(net)


def make_train_step(d: DeepLIIFDef, vgg_net):
    """step(state, batch, rng) -> (state, metrics, g_out): forward -> D
    gradients on detached fakes -> D update -> G gradients against the
    updated discriminators -> G update (``alternating_step``); with
    spectral norm then every ``spectral_u`` refreshed from the updated
    weights, as the JAX DeepLIIF step keeps them (the other families' JAX
    steps do not refresh)."""
    step = alternating_step(*alternating_parts(
        train_forward, d_loss_fn, g_loss_fn, d, vgg_net=vgg_net))
    if d.norm != 'spectral':
        return step

    def spectral_step(state, batch, rng=None):
        out = step(state, batch, rng)
        refresh_spectral(state.nets)
        return out
    return spectral_step


def make_eval_losses(d: DeepLIIFDef, vgg_net):
    """Validation losses without updates (``alternating_eval``)."""
    return alternating_eval(*alternating_parts(
        train_forward, d_loss_fn, g_loss_fn, d, vgg_net=vgg_net))
