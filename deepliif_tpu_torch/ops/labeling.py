"""On-device cell counting: connected-component labeling, component
statistics, KDE thresholds, classification and overlays, on torch tensors.

Port of deepliif_tpu/ops/labeling.py (the device quantifier). The seg
canvas goes from the nets to cell counts and overlays on the tensor's device:

  posneg_mask -> flood_background (4-connected labeling of the unknown
  pixels, border-label flag table) -> label_components (8-connected cells)
  -> _segment_stats (int32 index_add_) -> auto_size_threshold (KDE) /
  auto_marker_threshold -> keep / positive rules -> overlay_images

``label_components`` is the one kernel: on a CUDA tensor it launches
``csrc/label_cc.cu`` (union-find, the counterpart of the TPU kernel
``label_prop_pallas`` and the loop around it), on a CPU tensor it runs
``label_components_reference``, the plain version (min-propagation sweeps
with pointer jumping, the JAX package's XLA ``label_components``). Both give
the canonical labels: 0 for background, the minimum flat index of the
component + 1 elsewhere.

The JAX module sorts and scans for the per-component marker max because
scatter-max is slow on the TPU; here it is an int32 ``scatter_reduce``
('amax') and a gather, which gives the same values (integer maxima do not
depend on order). Mesh-sharded labeling is not ported (ROADMAP.md,
"Serving").
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..postprocessing import (LABEL_BACKGROUND, LABEL_NEGATIVE,
                              LABEL_POSITIVE, LABEL_UNKNOWN,
                              calculate_large_noise_thresh)
from . import cuda_build

_LIBS = {'label_cc': ['label_cc.cu']}

INF = torch.iinfo(torch.int32).max


def posneg_mask(seg, thresh):
    """Device version of create_posneg_mask: (H, W, 3) uint8 seg -> (H, W)
    uint8 mask of LABEL_POSITIVE / LABEL_NEGATIVE / LABEL_UNKNOWN."""
    seg = seg.to(torch.int32)
    cond = (seg[..., 0] + seg[..., 2] > thresh) & (seg[..., 1] <= 80)
    pos = seg[..., 0] >= seg[..., 2]
    out = torch.full(seg.shape[:2], LABEL_UNKNOWN, dtype=torch.uint8,
                     device=seg.device)
    out[cond] = LABEL_NEGATIVE
    out[cond & pos] = LABEL_POSITIVE
    return out


def _neighbor_min(lab, fg, conn8=True):
    """Min label over the (4- or 8-) neighborhood, foreground-masked."""
    h, w = lab.shape
    big = torch.where(fg, lab, INF)
    padded = F.pad(big, (1, 1, 1, 1), value=INF)
    shifts = [(0, 1), (2, 1), (1, 0), (1, 2)]
    if conn8:
        shifts += [(0, 0), (0, 2), (2, 0), (2, 2)]
    out = big
    for dy, dx in shifts:
        out = torch.minimum(out, padded[dy:dy + h, dx:dx + w])
    return torch.where(fg, out, INF)


def label_components_reference(fg, conn8=True, sweeps_per_jump=32):
    """Plain version of ``label_components``: ``sweeps_per_jump``
    neighbor-min sweeps, then one pointer jump (label <- label at the pixel
    it names), until nothing changes."""
    fg = fg.bool()
    h, w = fg.shape
    idx = torch.arange(h * w, dtype=torch.int32,
                       device=fg.device).reshape(h, w)
    lab = torch.where(fg, idx, INF)
    while True:
        new = lab
        for _ in range(sweeps_per_jump):
            new = _neighbor_min(new, fg, conn8)
        flat = new.reshape(-1)
        jumped = torch.where(flat == INF, INF, flat[flat.clamp(0, h * w - 1)])
        new = torch.minimum(new, jumped.reshape(h, w))
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(fg, lab + 1, 0)


@functools.cache
def _lib():
    lib = cuda_build.load('label_cc', _LIBS['label_cc'])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.label_cc.argtypes = [p, p, p, i, i, i, p]
    lib.label_cc.restype = i
    return lib


def label_components(fg, conn8=True):
    """Connected components of a (H, W) bool or uint8 mask (nonzero =
    foreground) as int32 labels: 0 for background, the minimum flat index of
    the component + 1 elsewhere; 8-connected, or 4 with ``conn8=False``.

    A CPU tensor runs ``label_components_reference``; a CUDA tensor launches
    ``csrc/label_cc.cu`` on the current stream and counts it in
    ``label_components.launches``, or raises."""
    if fg.device.type == 'cpu':
        return label_components_reference(fg, conn8)
    if fg.device.type != 'cuda':
        raise ValueError(f'label_components runs on cpu or cuda, got '
                         f'{fg.device}')
    if fg.dim() != 2 or fg.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f'label_components takes a (H, W) bool or uint8 '
                        f'mask, got {fg.dtype} {tuple(fg.shape)}')
    h, w = fg.shape
    if h * w >= 2 ** 31:
        raise ValueError(f'canvas {h}x{w} has 2^31 pixels or more: the '
                         'labels are int32 flat indices')
    fg = fg.contiguous()
    parent = torch.empty((h, w), dtype=torch.int32, device=fg.device)
    labels = torch.empty((h, w), dtype=torch.int32, device=fg.device)
    with torch.cuda.device(fg.device):
        err = _lib().label_cc(fg.data_ptr(), parent.data_ptr(),
                              labels.data_ptr(), h, w, int(conn8),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'label_cc kernel launch failed: cudaError {err}')
    label_components.launches += 1
    return labels


label_components.launches = 0


def flood_background(mask, labeler=label_components):
    """Device version of mark_background: unknown pixels 4-connected to the
    border become background."""
    h, w = mask.shape
    unk = mask == LABEL_UNKNOWN
    lab = labeler(unk, conn8=False)
    border = torch.cat([lab[0], lab[-1], lab[:, 0], lab[:, -1]])
    # a flag per label (labels are <= h * w); label 0 is no component
    flag = torch.zeros(h * w + 2, dtype=torch.bool, device=mask.device)
    flag[border] = True
    flag[0] = False
    return mask.masked_fill(unk & flag[lab], LABEL_BACKGROUND)


def _segment_stats(flat_lab, mask, n):
    """Per-label (size, pos pixel count, neg pixel count), int32."""
    def count(values):
        return torch.zeros(n, dtype=torch.int32, device=flat_lab.device
                           ).index_add_(0, flat_lab, values.to(torch.int32))
    m = mask.reshape(-1)
    return (count(torch.ones_like(flat_lab)), count(m == LABEL_POSITIVE),
            count(m == LABEL_NEGATIVE))


def _component_marker_max(flat_lab, marker_flat, n):
    """Per-label maximum of the marker, (n,) int32."""
    return torch.zeros(n, dtype=torch.int32, device=flat_lab.device
                       ).scatter_reduce_(0, flat_lab.long(),
                                         marker_flat.to(torch.int32), 'amax')


def _cells(seg, seg_thresh, labeler):
    """Posneg mask, background flood and 8-connected labeling of a seg
    canvas -> (fg mask, labels, per-label sizes (label 0: 0), per-label
    positive majority)."""
    mask = flood_background(posneg_mask(seg, seg_thresh), labeler)
    fg = mask != LABEL_BACKGROUND
    lab = labeler(fg, conn8=True)
    sizes, pos_cnt, neg_cnt = _segment_stats(lab.reshape(-1), mask,
                                             lab.numel() + 1)
    sizes[0] = 0
    return fg, lab, sizes, pos_cnt >= neg_cnt


def _classify(fg, lab, sizes, is_pos, keep, marker=None, marker_thresh=None):
    """Counts of the kept cells, positive and negative, and the per-pixel
    class image (uint8: 0 outside kept cells, 1 positive, 2 negative). With
    a marker and its threshold a cell is also positive where its marker max
    exceeds the threshold."""
    if marker is not None and marker_thresh is not None:
        is_pos = is_pos | (_component_marker_max(
            lab.reshape(-1), marker.reshape(-1), sizes.numel())
            > marker_thresh)
    counted = keep & (sizes > 0)
    cls = (keep[lab] & fg).to(torch.uint8) * (2 - is_pos[lab].to(torch.uint8))
    return (counted & is_pos).sum(), (counted & ~is_pos).sum(), cls


def quantify(seg_u8, marker_u8=None, seg_thresh=120, noise_thresh=4,
             large_noise_thresh=None, size_thresh=0, marker_thresh=None,
             size_thresh_upper=None, labeler=label_components,
             resolution='40x'):
    """Cell counting on the seg tensor's device: uint8 seg (H, W, 3) ->
    counts, the size threshold used and the per-pixel class image (0 bg,
    1 pos cell, 2 neg cell). Size gates are strict (>, <) as on the host.
    ``size_thresh='default'`` takes the KDE threshold at ``resolution`` over
    the cells that pass the noise gates (the host drops noise cells before
    calculate_default_size_threshold)."""
    fg, lab, sizes, is_pos = _cells(seg_u8, seg_thresh, labeler)
    cell_ok = sizes > noise_thresh
    if large_noise_thresh is not None:
        cell_ok &= sizes < large_noise_thresh
    if size_thresh == 'default':
        size_thresh = auto_size_threshold(torch.where(cell_ok, sizes, 0),
                                          resolution)
    keep = cell_ok & (sizes > size_thresh)
    if size_thresh_upper is not None:
        keep &= sizes < int(size_thresh_upper)
    num_pos, num_neg, cls = _classify(fg, lab, sizes, is_pos, keep,
                                      marker_u8, marker_thresh)
    return {'num_pos': num_pos, 'num_neg': num_neg,
            'num_total': num_pos + num_neg, 'class_image': cls,
            'labels': lab, 'sizes': sizes, 'size_thresh': size_thresh}


def _f32(value, device):
    return torch.tensor(value, dtype=torch.float32, device=device)


def auto_size_threshold(sizes, resolution='40x', max_cells=16384):
    """Device version of calculate_default_size_threshold: Gaussian KDE over
    sqrt cell sizes (float32, 500 bins), first strict local minimum,
    resolution clamping. sizes: dense (n,) int table where entries <= 0 mark
    non-cells; compacted to its ``max_cells`` largest entries first. Returns
    an int32 scalar tensor (0 when fewer than 2 cells)."""
    if sizes.numel() > max_cells:
        sizes = torch.topk(sizes, max_cells).values
    valid = sizes > 0
    n_cells = valid.sum().to(torch.int32)
    vals = torch.sqrt(torch.where(valid, sizes, 0).to(torch.float32))
    max_value = vals.max() + 1.0
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which can round one ulp apart
    step = max_value / _f32(500.0, sizes.device)
    x = torch.arange(500, dtype=torch.float32, device=sizes.device) * step
    z = x[:, None] - vals[None, :]
    contrib = torch.exp(-(z * z) / 2.0) * valid[None, :]
    # sqrt(2 pi) taken in float32, as jnp.sqrt of the Python float does
    norm = torch.sqrt(_f32(2 * math.pi, sizes.device))
    kde = contrib.sum(dim=1) / (norm * torch.clamp(n_cells, min=1))

    interior_min = (kde[1:-1] < kde[:-2]) & (kde[1:-1] < kde[2:])
    first = torch.argmax(interior_min.to(torch.uint8)) + 1
    idx = torch.where(interior_min.any(), first, 1)
    thresh_sqrt = (idx - 1).to(torch.float32) * step

    lo, mid, hi = {'40x': (4., 7., 10.), '20x': (3., 4., 6.),
                   '10x': (2., 2., 3.)}.get(resolution, (4., 7., 10.))
    thresh_sqrt = torch.where(thresh_sqrt < lo, lo,
                              torch.where(thresh_sqrt > hi, mid, thresh_sqrt))
    out = torch.round(thresh_sqrt * thresh_sqrt).to(torch.int32)
    return torch.where(n_cells > 1, out, 0)


def auto_marker_threshold(marker_u8):
    """Device version of calculate_default_marker_threshold: 90 % of the
    0.1-99.9 percentile range of the nonzero pixels, percentiles linearly
    interpolated in float32. Returns an int32 scalar tensor."""
    flat = marker_u8.reshape(-1).to(torch.float32)
    nz = flat > 0
    count = nz.sum().to(torch.int32)
    # nonzero values sort after the -1 that marks zeros
    s = torch.sort(torch.where(nz, flat, -1.0)).values
    start = flat.numel() - count

    def pct(q):
        pos = start.to(torch.float32) + (count - 1).to(torch.float32) \
            * _f32(q / 100.0, flat.device)
        lo = torch.floor(pos).to(torch.int32)
        hi = torch.ceil(pos).to(torch.int32)
        frac = pos - lo.to(torch.float32)
        n = flat.numel()
        return s[lo.clamp(0, n - 1)] * (1 - frac) \
            + s[hi.clamp(0, n - 1)] * frac

    lo = torch.round(pct(0.1))
    hi = torch.round(pct(99.9))
    thresh = torch.round((hi - lo) * 0.9) + lo
    return torch.where(count > 0, thresh, 0.0).to(torch.int32)


def _shift(a, dy, dx):
    """a moved by (dy - 1, dx - 1) pixels, zero-filled: the (dy, dx) window
    of a padded by one."""
    h, w = a.shape
    return F.pad(a.to(torch.uint8), (1, 1, 1, 1))[dy:dy + h, dx:dx + w].bool()


def overlay_images(orig_u8, cls):
    """Device version of boundary drawing + create_final_images: borders are
    background pixels 4-adjacent to cells, dilated twice (8-connected);
    positive wins where a pixel borders both classes."""
    def dilate(border_pos, border_neg, free):
        np_, nn_ = border_pos, border_neg
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                np_ = np_ | _shift(border_pos, dy, dx)
                nn_ = nn_ | _shift(border_neg, dy, dx)
        np_, nn_ = np_ & free, nn_ & free
        nn_ = nn_ & ~np_
        return border_pos | np_, border_neg | nn_

    free = cls == 0
    pos = cls == 1
    neg = cls == 2
    bp = torch.zeros_like(pos)
    bn = torch.zeros_like(neg)
    for dy, dx in ((0, 1), (1, 0), (1, 2), (2, 1)):
        bp = bp | _shift(pos, dy, dx)
        bn = bn | _shift(neg, dy, dx)
    bp, bn = bp & free, bn & free & ~bp
    free2 = free & ~bp & ~bn
    bp, bn = dilate(bp, bn, free2)
    free3 = free2 & ~bp & ~bn
    bp, bn = dilate(bp, bn, free3)

    def color(rgb):
        return torch.tensor(rgb, dtype=torch.uint8, device=orig_u8.device)

    overlay = torch.where(bp[..., None], color([255, 0, 0]), orig_u8)
    overlay = torch.where(bn[..., None], color([0, 0, 255]), overlay)
    refined = torch.stack([pos, bp | bn, neg], dim=-1).to(torch.uint8) * 255
    return overlay, refined


def _run(seg, orig, marker, *, resolution, auto_size, auto_marker,
         static_size, static_marker, size_thresh_upper, seg_thresh,
         noise_thresh, large_noise, labeler):
    """The quantifier on the tensors' device (the JAX package's jitted
    program): uint8 seg (H, W, 3), orig (H, W, 3), marker (H, W) or None ->
    overlay, refined, counts and the thresholds used."""
    if auto_marker and marker is not None:
        mt = auto_marker_threshold(marker)
    else:
        mt = static_marker
    q = quantify(seg, marker, seg_thresh, noise_thresh, large_noise,
                 'default' if auto_size else static_size, mt,
                 size_thresh_upper, labeler, resolution)
    overlay, refined = overlay_images(orig, q['class_image'])
    return {'overlay': overlay, 'refined': refined, 'num_pos': q['num_pos'],
            'num_neg': q['num_neg'], 'size_thresh': q['size_thresh'],
            'marker_thresh': mt if mt is not None else -1}


def compute_final_results_device(orig_u8, seg_u8, marker_u8=None,
                                 resolution='40x', size_thresh='default',
                                 marker_thresh=None, size_thresh_upper=None,
                                 seg_thresh=120, noise_thresh=4,
                                 large_noise_thresh=None, device=None,
                                 labeler=label_components):
    """Device mirror of postprocessing.compute_final_results: posneg mask ->
    background flood -> labeling -> KDE auto size threshold ->
    classification -> overlay / refined images, on ``device`` (default: the
    device of ``seg_u8`` when it is a tensor, else cuda). Returns (overlay,
    refined, scoring) as numpy arrays and the host's scoring dict.

    ``seg_u8`` may be a tensor already on the device (the stitched canvas of
    the inference path) or a numpy array; ``orig_u8`` and ``marker_u8`` are
    numpy arrays. ``labeler`` is the labeling function (the plain version
    can be passed to check the kernel against it)."""
    large_noise = calculate_large_noise_thresh(large_noise_thresh, resolution)
    auto_size = size_thresh == 'default'
    auto_marker = marker_thresh == 'default'
    static_size = 0 if (auto_size or size_thresh is None) else int(size_thresh)
    static_marker = None if (auto_marker or marker_thresh is None) \
        else int(marker_thresh)
    run = functools.partial(
        _run, resolution=resolution, auto_size=auto_size,
        auto_marker=auto_marker, static_size=static_size,
        static_marker=static_marker, size_thresh_upper=size_thresh_upper,
        seg_thresh=seg_thresh, noise_thresh=noise_thresh,
        large_noise=large_noise, labeler=labeler)
    if device is None:
        device = seg_u8.device if isinstance(seg_u8, torch.Tensor) else 'cuda'
    return _finish(run, orig_u8, seg_u8, marker_u8, size_thresh,
                   size_thresh_upper, seg_thresh, marker_thresh,
                   torch.device(device))


def _finish(run, orig_u8, seg_u8, marker_u8, size_thresh, size_thresh_upper,
            seg_thresh, marker_thresh, device):
    """Pads the canvases to multiples of 256, runs the quantifier on
    ``device`` and builds the scoring dict. The padding keeps the sizes
    table at h * w + 1 >= 65537 entries, so the KDE always runs on the
    16384 largest entries, as in the JAX package; the zero padding is
    'unknown' and border-connected, so it floods to background and changes
    no count."""
    h0, w0 = int(seg_u8.shape[0]), int(seg_u8.shape[1])
    ph, pw = (-h0) % 256, (-w0) % 256

    def padded(a):
        t = a.to(device) if isinstance(a, torch.Tensor) else \
            torch.tensor(np.asarray(a), device=device)
        pad = (0, pw, 0, ph) if t.dim() == 2 else (0, 0, 0, pw, 0, ph)
        return F.pad(t, pad).contiguous() if ph or pw else t.contiguous()

    out = run(padded(seg_u8), padded(orig_u8),
              None if marker_u8 is None else padded(marker_u8))

    num_pos = int(out['num_pos'])
    num_neg = int(out['num_neg'])
    mt_val = int(out['marker_thresh'])
    scoring = {
        'num_total': num_pos + num_neg,
        'num_pos': num_pos,
        'num_neg': num_neg,
        'percent_pos': (round(num_pos / (num_pos + num_neg) * 100, 1)
                        if num_pos > 0 else 0),
        'seg_thresh': seg_thresh,
        'size_thresh': (int(out['size_thresh']) if size_thresh is not None
                        else 0),
        'size_thresh_upper': size_thresh_upper,
        'marker_thresh': (None if marker_u8 is None
                          else (mt_val if mt_val >= 0 else marker_thresh)),
    }
    overlay = out['overlay'][:h0, :w0].cpu().numpy()
    refined = out['refined'][:h0, :w0].cpu().numpy()
    return overlay, refined, scoring
