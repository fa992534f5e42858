"""Cell quantification / postprocessing on the host: the port's own copy of
deepliif_tpu/postprocessing.py, with its native helper built from
``csrc/postproc.cc`` (``deepliif_tpu_torch.native``).

Re-implements the reference's 13 Numba nopython kernels
(reference deepliif/postprocessing.py) as vectorized numpy/scipy host
ops with EXACT output semantics (counts, sizes, centroids, marker values,
overlay pixels), replacing sequential flood fills with connected-component
labeling:

  * create_posneg_mask (ref :163-190)  -> vectorized thresholding
  * mark_background    (ref :193-233)  -> 4-connected CC of unknown pixels;
                                          components touching the border are
                                          background (same fixpoint as the
                                          reference's iterative region grow)
  * compute_cell_mapping (ref :235-308)-> 8-connected CC with per-component
                                          stats; components ordered by first
                                          raster pixel like the scan order
  * create_cell_classification (ref :923-1000) -> vectorized relabel; border
                                          claims resolve first-writer-wins in
                                          cell order like the sequential code
  * enlarge_cell_boundaries (ref :1003-1030) -> two-phase dilation with
                                          raster-order claim priority
  * create_final_images / fill_cells / create_outer_boundary, KDE size
    threshold, marker threshold, Moore boundary tracing, base92 + Freeman
    chain cell encodings v3/4/5/6, compute_cell_results /
    compute_final_results / cells_to_final_results — full API parity.

The JAX package also has a device-side variant of the mask/labeling path;
in the port it is not ported yet (ROADMAP.md, "Device quantification").
This host module is the reference semantics and the port's only
quantification path.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
from scipy import ndimage

# Default postprocessing values (ref :82-95)
DEFAULT_SEG_THRESH = 120
DEFAULT_NOISE_THRESH = 4

LABEL_UNKNOWN = 50
LABEL_POSITIVE = 200
LABEL_NEGATIVE = 150
LABEL_BACKGROUND = 0
LABEL_CELL = 100
LABEL_BORDER_POS = 220
LABEL_BORDER_NEG = 170

_S4 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
_S8 = np.ones((3, 3), bool)

# neighbor offsets in raster order of the *neighbor* position — the claim
# priority for in-place sequential dilations
_RASTER8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
_RASTER4 = [(-1, 0), (0, -1), (0, 1), (1, 0)]


def imadjust(x, gamma=0.7, c=0, d=1):
    """Contrast adjustment (ref :10-23). Constant input returns ``c``
    everywhere (the reference divides by zero there; strict improvement,
    not a parity break — that input NaNs the reference)."""
    x = np.asarray(x, np.float64)
    a, b = x.min(), x.max()
    if b == a:
        return np.full_like(x, c)
    return (((x - a) / (b - a)) ** gamma) * (d - c) + c


def adjust_dapi(inferred_tile, orig_tile):
    """Adjust inferred DAPI intensity to the original tile's statistics
    (ref :26-51)."""
    inferred = np.asarray(inferred_tile)
    orig = np.asarray(orig_tile)
    multiplier = 8 / math.log(max(np.max(orig), 2))
    if np.mean(orig) < 200:
        gamma = multiplier * math.log(max(np.mean(inferred), 2)) / \
            math.log(max(np.mean(orig), 2))
    else:
        gamma = multiplier
    out = imadjust(inferred.astype(float), gamma=gamma, c=5, d=255).astype(np.uint8)
    from PIL import Image
    return Image.fromarray(out)


def adjust_marker(inferred_tile, orig_tile):
    """Adjust inferred marker intensity (ref :54-79; uses std instead of
    mean for the gamma ratio)."""
    inferred = np.asarray(inferred_tile)
    orig = np.asarray(orig_tile)
    multiplier = 8 / math.log(max(np.max(orig), 2))
    if np.mean(orig) < 200:
        gamma = multiplier * math.log(max(np.std(inferred), 2)) / \
            math.log(max(np.std(orig), 2))
    else:
        gamma = multiplier
    out = imadjust(inferred.astype(float), gamma=gamma, c=5, d=255).astype(np.uint8)
    from PIL import Image
    return Image.fromarray(out)


def to_array(img, grayscale=False):
    from PIL import Image
    if isinstance(img, Image.Image):
        img = np.asarray(img if img.mode == 'RGB' else img.convert('RGB'))
    img = np.asarray(img)
    if grayscale and img.ndim == 3:
        img = img.max(axis=-1)
    return img


def create_od_image(orig):
    """Optical-density image (ref :123-138): od = round(100 * sum_c log10(255/c))."""
    lut = np.empty(256, np.float64)
    lut[1:] = np.log10(255.0 / np.arange(1, 256))
    lut[0] = lut[1]
    val = lut[orig[..., 0]] + lut[orig[..., 1]] + lut[orig[..., 2]]
    return np.round(val * 100).astype(np.uint16)


def create_posneg_mask(seg, thresh):
    """R+B > thresh and G <= 80; R >= B -> positive (ref :163-190)."""
    seg = np.asarray(seg)
    rb = seg[..., 0].astype(np.int32) + seg[..., 2].astype(np.int32)
    cond = (rb > thresh) & (seg[..., 1] <= 80)
    pos = seg[..., 0] >= seg[..., 2]
    mask = np.full(seg.shape[:2], LABEL_UNKNOWN, np.uint8)
    mask[cond & pos] = LABEL_POSITIVE
    mask[cond & ~pos] = LABEL_NEGATIVE
    return mask


def mark_background(mask):
    """In-place: unknown pixels 4-connected to the image border become
    background (ref :193-233 computes the same fixpoint iteratively)."""
    unk = mask == LABEL_UNKNOWN
    if not unk.any():
        return
    lab, _ = ndimage.label(unk, structure=_S4)
    border_labels = np.unique(np.concatenate(
        [lab[0], lab[-1], lab[:, 0], lab[:, -1]]))
    border_labels = border_labels[border_labels != 0]
    if border_labels.size:
        mask[np.isin(lab, border_labels)] = LABEL_BACKGROUND


def _label_cells(mask):
    """8-connected components of non-background pixels, ordered by first
    raster pixel (the reference scan-discovery order). Uses the native C
    union-find when available, else scipy."""
    from . import native
    res = native.label8((mask != LABEL_BACKGROUND).astype(np.uint8))
    if res is not None:
        lab, n = res
    else:
        lab, n = ndimage.label(mask != LABEL_BACKGROUND, structure=_S8)
    if n == 0:
        return lab, np.array([], np.int64), np.array([], np.int64)
    flat = lab.ravel()
    # first occurrence (raster index) per label
    first = np.full(n + 1, flat.size, np.int64)
    np.minimum.at(first, flat, np.arange(flat.size, dtype=np.int64))
    order = np.argsort(first[1:], kind='stable') + 1  # label ids in scan order
    return lab, order, first


def compute_cell_mapping(mask, marker, noise_thresh, large_noise_thresh,
                         use_avg=False):
    """Per-cell stats with size gating (ref :235-308). Returns the list of
    7-tuples (size, positive, marker_val, first_x, first_y, cx, cy) in scan
    order and relabels kept+skipped cell pixels to LABEL_CELL in-place."""
    h, w = mask.shape
    lab, order, first = _label_cells(mask)
    n = order.size
    cells = []
    if n:
        flat = lab.ravel()
        sizes = np.bincount(flat, minlength=n + 1)
        posc = np.bincount(flat[(mask == LABEL_POSITIVE).ravel()], minlength=n + 1)
        negc = np.bincount(flat[(mask == LABEL_NEGATIVE).ravel()], minlength=n + 1)
        ys, xs = np.nonzero(lab)
        ids = lab[ys, xs]
        sum_y = np.bincount(ids, weights=ys, minlength=n + 1)
        sum_x = np.bincount(ids, weights=xs, minlength=n + 1)
        if marker is not None:
            mk = marker[ys, xs].astype(np.float64)
            if use_avg:
                mval = np.bincount(ids, weights=mk, minlength=n + 1)
            else:
                mval = np.zeros(n + 1, np.float64)
                np.maximum.at(mval, ids, mk)

        for li in order:
            count = int(sizes[li])
            if count > noise_thresh and (large_noise_thresh is None
                                         or count < large_noise_thresh):
                fy, fx = divmod(int(first[li]), w)
                cy = int(round(sum_y[li] / count))
                cx = int(round(sum_x[li] / count))
                positive = bool(posc[li] >= negc[li])
                if marker is None:
                    mv = 0
                elif use_avg:
                    mv = int(round(mval[li] / count))
                else:
                    mv = int(mval[li])
                cells.append((count, positive, mv, fx, fy, cx, cy))
    mask[lab != 0] = LABEL_CELL
    return cells, lab


def get_cells_info(seg, marker, resolution, noise_thresh, seg_thresh,
                   large_noise_thresh, use_od=False):
    """(ref :311-362). Returns (mask, cells, label_image, defaults)."""
    seg = to_array(seg)
    if marker is not None and use_od:
        marker = create_od_image(to_array(marker))
    elif marker is not None:
        marker = to_array(marker, True)

    mask = create_posneg_mask(seg, seg_thresh)
    mark_background(mask)
    cells, lab = compute_cell_mapping(mask, marker, noise_thresh,
                                      large_noise_thresh, use_od)
    defaults = {}
    sizes = np.asarray([c[0] for c in cells], np.int64)
    defaults['size_thresh'] = calculate_default_size_threshold(sizes, resolution)
    if marker is not None and not use_od:
        defaults['marker_thresh'] = calculate_default_marker_threshold(marker)
    return mask, cells, lab, defaults


def create_kde(values, count, bandwidth=1.0):
    """Gaussian KDE over `count` bins (ref :365-403) — one matmul-shaped
    broadcast instead of the O(bins*n) scalar loop."""
    values = np.asarray(values, np.float64)
    max_value = values.max() + 1
    step = max_value / count
    x = np.arange(count) * step
    z = (x[:, None] - values[None, :]) / bandwidth
    kde = (np.exp(-(z * z) / 2) / math.sqrt(2 * math.pi)).sum(axis=1)
    return (kde / (values.size * bandwidth)).astype(np.float32), step


def calculate_default_size_threshold(cell_sizes, resolution='40x'):
    """First local KDE minimum of sqrt sizes, clamped per resolution
    (ref :406-447)."""
    if cell_sizes.shape[0] <= 1:
        return 0
    kde, step = create_kde(np.sqrt(cell_sizes), 500)
    idx = 1
    for i in range(1, kde.shape[0] - 1):
        if kde[i] < kde[i - 1] and kde[i] < kde[i + 1]:
            idx = i
            break
    thresh_sqrt = (idx - 1) * step
    allowed = {'40x': (4, 7, 10), '20x': (3, 4, 6), '10x': (2, 2, 3)}.get(
        resolution, (4, 7, 10))
    if thresh_sqrt < allowed[0]:
        thresh_sqrt = allowed[0]
    elif thresh_sqrt > allowed[2]:
        thresh_sqrt = allowed[1]
    return round(thresh_sqrt * thresh_sqrt)


def calculate_stain_range(stain):
    nonzero = stain[stain != 0]
    if nonzero.shape[0] > 0:
        return (round(np.percentile(nonzero, 0.1)),
                round(np.percentile(nonzero, 99.9)))
    return (0, 0)


def calculate_default_marker_threshold(marker):
    lo, hi = calculate_stain_range(marker)
    return round((hi - lo) * 0.9) + lo


# ---------------------------------------------------------------------------
# boundary tracing (Moore neighborhood, ref :491-581)
# ---------------------------------------------------------------------------

_MOORE = [(-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0)]


def get_cell_boundary(mask, x, y, _use_native=True):
    """Clockwise boundary contour + bbox, starting from the first raster
    pixel of the cell. Exact port of the reference tracing order; uses the
    native C tracer when available."""
    h, w = mask.shape
    if not (0 <= y < h and 0 <= x < w) or mask[y, x] == LABEL_BACKGROUND:
        return None, None
    if _use_native:
        from . import native
        res = native.moore_trace(mask, x, y)
        if res is not None:
            bbox, boundary = res
            if len(boundary) == 1:
                return [boundary[0], boundary[0]], boundary
            return bbox, boundary
    neighbors = _MOORE * 2

    idx = 6
    while idx >= 0:
        nx, ny = x + neighbors[idx][0], y + neighbors[idx][1]
        if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] != LABEL_BACKGROUND:
            break
        idx -= 1
    if idx < 0:
        return [(x, y), (x, y)], [(x, y)]

    px, py = x + neighbors[idx][0], y + neighbors[idx][1]
    boundary = [(px, py), (x, y)]
    min_x = max_x = x
    min_y = max_y = y

    while True:
        dx, dy = px - x, py - y
        idx = _MOORE.index((dx, dy)) + 1
        while True:
            nx, ny = x + neighbors[idx][0], y + neighbors[idx][1]
            if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] != LABEL_BACKGROUND:
                break
            idx += 1
        px, py = x, y
        x, y = nx, ny
        boundary.append((x, y))
        min_x, max_x = min(min_x, x), max(max_x, x)
        min_y, max_y = min(min_y, y), max(max_y, y)
        if (px, py) == boundary[0] and (x, y) == boundary[1]:
            break

    return [(min_x, min_y), (max_x, max_y)], boundary[1:-1]


def make_simple_contour(points):
    """Collinearity pruning, vectorized: a closed chain contour keeps only
    the vertices where the step *direction* (sign of the delta, per axis)
    changes between the incoming and outgoing edge. The first vertex is
    always kept. Output matches the reference simplifier (ref :584-634) on
    any closed chain, including the wrap-around check at the last vertex.
    """
    pts = np.asarray(points, np.int64)
    if len(pts) < 2:
        return [(int(p[0]), int(p[1])) for p in pts]
    ring = np.concatenate([pts, pts[:1]], axis=0)
    out_dir = np.sign(np.diff(ring, axis=0))        # edge leaving vertex i
    in_dir = np.roll(out_dir, 1, axis=0)            # edge arriving at vertex i
    keep = (out_dir != in_dir).any(axis=1)
    keep[0] = True
    return [(int(x), int(y)) for x, y in pts[keep]]


def make_full_contour(points):
    """Inverse of make_simple_contour: densify each straight or perfectly
    diagonal segment of a simplified closed contour back into unit chain
    steps. The closing run stops one pixel short of the start vertex so the
    contour has no duplicate point (ref :637-682 semantics)."""
    pts = [(int(p[0]), int(p[1])) for p in points]
    full = [pts[0]]
    ring = pts + pts[:1]
    for i in range(1, len(ring)):
        (x0, y0), (x1, y1) = full[-1], ring[i]
        sx = (x1 > x0) - (x1 < x0)
        sy = (y1 > y0) - (y1 < y0)
        n = max(abs(x1 - x0), abs(y1 - y0))
        if i == len(ring) - 1:
            n -= 1  # closing run: stop one pixel before the start vertex
        full.extend((x0 + sx * k, y0 + sy * k) for k in range(1, n + 1))
    return full


# ---------------------------------------------------------------------------
# base92 + Freeman chain cell encodings (ref :685-920)
# ---------------------------------------------------------------------------

def to_base92(values, min_len=1):
    multi = isinstance(values, (list, tuple))
    if not multi:
        values = [values]
    results = []
    for val in values:
        res = ''
        while val > 0:
            res += chr((val % 92) + 35)
            val //= 92
        results.append(res)
    fixed_len = max(max(len(r) for r in results), min_len)
    results = [(r + chr(35) * (fixed_len - len(r)))[::-1] for r in results]
    return results if multi else results[0]


def from_base92(val):
    res = 0
    for v in val:
        res = res * 92 + (ord(v) - 35)
    return res


_FREEMAN = [(1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1)]


def encode_cell_data_v4(data, v6=False):
    cell = ''
    size = to_base92(data['size'])
    size_len = len(size)
    cell += size

    positive = int(data['positive'])
    marker = data['od'] if v6 else data['marker']
    cell += to_base92((marker * 2) + positive, 2)

    topleft = to_base92(list(data['bbox'][0]))
    topleft_len = len(topleft[0])
    cell += topleft[0] + topleft[1]

    x, y = data['bbox'][0]
    offsets = [*data['bbox'][1], *data['centroid'], *data['boundary'][0]]
    for j in range(0, len(offsets), 2):
        offsets[j] -= x
        offsets[j + 1] -= y
    offsets = to_base92(offsets)
    offsets_len = len(offsets[0])
    cell += ''.join(offsets)

    encoded_lens = ((size_len - 1) * 16) + ((topleft_len - 1) * 4) + (offsets_len - 1)
    cell = chr(encoded_lens + 35) + cell

    boundary = ''
    for j in range(1, len(data['boundary'])):
        dx = data['boundary'][j][0] - data['boundary'][j - 1][0]
        dy = data['boundary'][j][1] - data['boundary'][j - 1][1]
        sx = 1 if dx >= 1 else (-1 if dx <= -1 else 0)
        sy = 1 if dy >= 1 else (-1 if dy <= -1 else 0)
        direction = _FREEMAN.index((sx, sy)) if (sx, sy) != (0, 0) else None
        if direction is None:
            continue
        distance = max(abs(dx), abs(dy))
        while distance > 10:
            boundary += chr((10 * 8) + direction + 35)
            distance -= 10
        boundary += chr((distance * 8) + direction + 35)
    return cell + boundary


def decode_cell_data_v4(cell, v6=False):
    data = {}
    n = ord(cell[0]) - 35
    ns = (n // 16) + 1
    na = ((n // 4) % 4) + 1
    no = (n % 4) + 1

    data['size'] = from_base92(cell[1:1 + ns])
    classification = from_base92(cell[1 + ns:3 + ns])
    data['positive'] = bool(classification % 2)
    if v6:
        data['od'] = classification // 2
    else:
        data['marker'] = classification // 2

    p = 3 + ns
    x = from_base92(cell[p:p + na])
    y = from_base92(cell[p + na:p + 2 * na])
    q = p + 2 * na
    ex = x + from_base92(cell[q:q + no])
    ey = y + from_base92(cell[q + no:q + 2 * no])
    data['bbox'] = [(x, y), (ex, ey)]
    cx = x + from_base92(cell[q + 2 * no:q + 3 * no])
    cy = y + from_base92(cell[q + 3 * no:q + 4 * no])
    data['centroid'] = (cx, cy)
    bx = x + from_base92(cell[q + 4 * no:q + 5 * no])
    by = y + from_base92(cell[q + 5 * no:q + 6 * no])
    data['boundary'] = [(bx, by)]

    prev_direction = None
    for c in cell[q + 6 * no:]:
        point = ord(c) - 35
        distance = point // 8
        direction = _FREEMAN[point % 8]
        px = data['boundary'][-1][0] + direction[0] * distance
        py = data['boundary'][-1][1] + direction[1] * distance
        if direction == prev_direction:
            data['boundary'].pop()
        data['boundary'].append((px, py))
        prev_direction = direction
    return data


# ---------------------------------------------------------------------------
# classification / final images (vectorized; ref :923-1122)
# ---------------------------------------------------------------------------

def _shifted(a, dy, dx, fill=0):
    out = np.full_like(a, fill)
    h, w = a.shape
    ys, yd = (dy, 0) if dy >= 0 else (0, -dy)
    xs, xd = (dx, 0) if dx >= 0 else (0, -dx)
    out[yd:h - ys, xd:w - xs] = a[ys:h - yd, xs:w - xd]
    return out


def create_cell_classification(mask, cells, lab,
                               size_thresh=0, marker_thresh=None,
                               size_thresh_upper=None,
                               od_thresh_lower=None, od_thresh_upper=None):
    """Relabel kept cells to pos/neg and draw 4-neighbor borders in-place
    (ref :923-1000). Border claims resolve first-cell-wins like the
    sequential version. Returns the counts dict."""
    h, w = mask.shape
    n_labels = int(lab.max())
    # final polarity per label: 0 = skip, 1 = pos, 2 = neg
    pol = np.zeros(n_labels + 1, np.uint8)
    # order index per label for claim priority (lower = earlier cell)
    order_of = np.full(n_labels + 1, np.iinfo(np.int32).max, np.int32)

    num_pos = num_neg = 0
    seeds = []
    for ci, cell in enumerate(cells):
        count, positive, marker_val, fx, fy = cell[0], cell[1], cell[2], cell[3], cell[4]
        if count > size_thresh and (size_thresh_upper is None
                                    or count < size_thresh_upper):
            is_pos = positive
            if marker_thresh is not None and marker_val > marker_thresh:
                is_pos = True
            if od_thresh_lower is not None and marker_val < od_thresh_lower:
                is_pos = False
            elif od_thresh_upper is not None and marker_val > od_thresh_upper:
                is_pos = False
            li = int(lab[fy, fx])
            pol[li] = 1 if is_pos else 2
            order_of[li] = ci
            seeds.append((fy, fx, is_pos))
            if is_pos:
                num_pos += 1
            else:
                num_neg += 1

    cellpix = (mask == LABEL_CELL) & (pol[lab] != 0)
    mask[cellpix & (pol[lab] == 1)] = LABEL_POSITIVE
    mask[cellpix & (pol[lab] == 2)] = LABEL_NEGATIVE

    # borders: background pixels 4-adjacent to kept-cell pixels (excluding the
    # seed pixel, which the sequential code border-labels directly)
    claim_src = np.where(cellpix, order_of[lab], np.iinfo(np.int32).max)
    for fy, fx, _ in seeds:
        claim_src[fy, fx] = np.iinfo(np.int32).max  # seeds don't spread borders
    claim = np.full((h, w), np.iinfo(np.int32).max, np.int32)
    for dy, dx in _RASTER4:
        claim = np.minimum(claim, _shifted(claim_src, dy, dx,
                                           np.iinfo(np.int32).max))
    bg = mask == LABEL_BACKGROUND
    has_claim = bg & (claim != np.iinfo(np.int32).max)
    if has_claim.any():
        # polarity of the claiming cell
        order_to_pol = np.zeros(len(cells) + 1, np.uint8)
        for ci, cell in enumerate(cells):
            li_pol = pol[int(lab[cell[4], cell[3]])]
            order_to_pol[ci] = li_pol
        claimed_pol = order_to_pol[np.where(has_claim, claim, 0)]
        mask[has_claim & (claimed_pol == 1)] = LABEL_BORDER_POS
        mask[has_claim & (claimed_pol == 2)] = LABEL_BORDER_NEG

    for fy, fx, is_pos in seeds:
        mask[fy, fx] = LABEL_BORDER_POS if is_pos else LABEL_BORDER_NEG

    return {'num_total': num_pos + num_neg, 'num_pos': num_pos,
            'num_neg': num_neg}


def enlarge_cell_boundaries(mask):
    """Dilate borders by one pixel into background, raster-claim priority
    (ref :1003-1030)."""
    bg = mask == LABEL_BACKGROUND
    claimed = np.zeros_like(mask)
    for dy, dx in _RASTER8:
        nb = _shifted(mask, dy, dx, LABEL_BACKGROUND)
        is_border = (nb == LABEL_BORDER_POS) | (nb == LABEL_BORDER_NEG)
        newly = bg & (claimed == 0) & is_border
        claimed[newly] = nb[newly]
    mask[claimed != 0] = claimed[claimed != 0]


def create_final_images(overlay, mask):
    """(ref :1033-1071)"""
    refined = np.zeros_like(overlay)
    bp = mask == LABEL_BORDER_POS
    bn = mask == LABEL_BORDER_NEG
    overlay[bp] = (255, 0, 0)
    overlay[bn] = (0, 0, 255)
    refined[bp | bn, 1] = 255
    refined[mask == LABEL_POSITIVE, 0] = 255
    refined[mask == LABEL_NEGATIVE, 2] = 255
    return overlay, refined


def fill_cells(mask):
    """Scanline fill of cell interiors (ref :1074-1099): an unknown pixel
    becomes positive iff the nearest non-unknown pixel to its left (after
    filling) is border-pos or positive; column 0 is never filled."""
    h, w = mask.shape
    unknown = mask == LABEL_UNKNOWN
    # index of nearest non-unknown pixel to the left (exclusive), per row
    idx = np.arange(w)[None, :].repeat(h, 0)
    idx[unknown] = 0
    left_src = np.maximum.accumulate(idx, axis=1)
    left_val = mask[np.arange(h)[:, None], left_src]
    fill_pos = (left_val == LABEL_BORDER_POS) | (left_val == LABEL_POSITIVE)
    target = unknown.copy()
    target[:, 0] = False
    mask[target & fill_pos] = LABEL_POSITIVE
    mask[target & ~fill_pos] = LABEL_NEGATIVE
    mask[mask == LABEL_BORDER_POS] = LABEL_POSITIVE
    mask[mask == LABEL_BORDER_NEG] = LABEL_NEGATIVE


def create_outer_boundary(mask):
    """Border labels on background 4-neighbors of cells (ref :1102-1122),
    raster-claim priority of the claiming cell pixel."""
    bg = mask == LABEL_BACKGROUND
    claimed = np.zeros_like(mask)
    for dy, dx in _RASTER4:
        nb = _shifted(mask, dy, dx, LABEL_BACKGROUND)
        is_cell = (nb == LABEL_POSITIVE) | (nb == LABEL_NEGATIVE)
        newly = bg & (claimed == 0) & is_cell
        claimed[newly] = np.where(nb[newly] == LABEL_POSITIVE,
                                  LABEL_BORDER_POS, LABEL_BORDER_NEG)
    mask[claimed != 0] = claimed[claimed != 0]


def calculate_large_noise_thresh(large_noise_thresh, resolution):
    if large_noise_thresh != 'default':
        return large_noise_thresh
    return {'10x': 1000, '20x': 4000}.get(resolution, 16000)


# ---------------------------------------------------------------------------
# orchestrators (ref :1136-1412)
# ---------------------------------------------------------------------------

def compute_cell_results(seg, marker, resolution, version=3,
                         seg_thresh=DEFAULT_SEG_THRESH,
                         noise_thresh=DEFAULT_NOISE_THRESH,
                         large_noise_thresh=None):
    if version not in (3, 4, 5, 6):
        warnings.warn('Invalid cell data version provided, defaulting to version 3.')
        version = 3
    large_noise_thresh = calculate_large_noise_thresh(large_noise_thresh, resolution)
    use_od = version in (5, 6)
    mask, cellsinfo, lab, defaults = get_cells_info(
        seg, marker, resolution, noise_thresh, seg_thresh, large_noise_thresh,
        use_od)

    cells = []
    for cell in cellsinfo:
        bbox, boundary = get_cell_boundary(mask, cell[3], cell[4])
        key = 'od' if use_od else 'marker'
        data = {
            'size': cell[0],
            'positive': cell[1],
            key: cell[2],
            'bbox': bbox,
            'centroid': (cell[5], cell[6]),
            'boundary': make_simple_contour(boundary),
        }
        if version in (4, 6):
            data = encode_cell_data_v4(data, v6=(version == 6))
        cells.append(data)

    settings = {
        'default_size_thresh': defaults['size_thresh'],
        'noise_thresh': noise_thresh,
        'large_noise_thresh': large_noise_thresh,
        'seg_thresh': seg_thresh,
    }
    if version in (3, 4):
        settings['default_marker_thresh'] = defaults.get('marker_thresh')
    return {'cells': cells, 'settings': settings, 'dataVersion': version}


def compute_final_results(orig, seg, marker, resolution,
                          size_thresh='default', marker_thresh=None,
                          size_thresh_upper=None,
                          seg_thresh=DEFAULT_SEG_THRESH,
                          noise_thresh=DEFAULT_NOISE_THRESH,
                          large_noise_thresh=None,
                          od_thresh_lower=None, od_thresh_upper=None):
    large_noise_thresh = calculate_large_noise_thresh(large_noise_thresh, resolution)
    if od_thresh_lower is not None or od_thresh_upper is not None:
        mask, cellsinfo, lab, defaults = get_cells_info(
            seg, orig, resolution, noise_thresh, seg_thresh,
            large_noise_thresh, use_od=True)
    else:
        mask, cellsinfo, lab, defaults = get_cells_info(
            seg, marker, resolution, noise_thresh, seg_thresh,
            large_noise_thresh, use_od=False)

    if size_thresh is None:
        size_thresh = 0
    elif size_thresh == 'default':
        size_thresh = defaults['size_thresh']
    if marker_thresh == 'default':
        if 'marker_thresh' not in defaults:
            raise ValueError(
                "marker_thresh='default' needs an inferred marker image "
                "and intensity thresholds (not optical-density mode)")
        marker_thresh = defaults['marker_thresh']

    counts = create_cell_classification(mask, cellsinfo, lab, size_thresh,
                                        marker_thresh, size_thresh_upper,
                                        od_thresh_lower, od_thresh_upper)
    enlarge_cell_boundaries(mask)
    enlarge_cell_boundaries(mask)
    overlay, refined = create_final_images(np.array(to_array(orig)), mask)

    scoring = {
        'num_total': counts['num_total'],
        'num_pos': counts['num_pos'],
        'num_neg': counts['num_neg'],
        'percent_pos': round(counts['num_pos'] / counts['num_total'] * 100, 1)
                       if counts['num_pos'] > 0 else 0,
        'seg_thresh': seg_thresh,
        'size_thresh': size_thresh,
        'size_thresh_upper': size_thresh_upper,
        'marker_thresh': marker_thresh if marker is not None else None,
    }
    return overlay, refined, scoring


def cells_to_final_results(data, orig, size_thresh='default',
                           marker_thresh=None, size_thresh_upper=None,
                           od_thresh_lower=None, od_thresh_upper=None):
    """Re-score from stored cell data without rerunning inference
    (ref :1307-1412)."""
    if data['dataVersion'] in (3, 4):
        od_thresh_lower = od_thresh_upper = None
    elif data['dataVersion'] in (5, 6):
        marker_thresh = None

    orig = np.array(to_array(orig))
    mask = np.full(orig.shape[:2], LABEL_UNKNOWN, np.uint8)
    num_pos = num_neg = 0

    if size_thresh is None:
        size_thresh = 0
    elif size_thresh == 'default':
        size_thresh = data['settings']['default_size_thresh']
    if marker_thresh == 'default':
        marker_thresh = data['settings']['default_marker_thresh']

    for cell in data['cells']:
        if data['dataVersion'] == 4:
            c = decode_cell_data_v4(cell)
        elif data['dataVersion'] == 6:
            c = decode_cell_data_v4(cell, v6=True)
        else:
            c = cell
        if c['size'] > size_thresh and (size_thresh_upper is None
                                        or c['size'] < size_thresh_upper):
            is_pos = c['positive']
            if marker_thresh is not None and c['marker'] > marker_thresh:
                is_pos = True
            if od_thresh_lower is not None and c['od'] < od_thresh_lower:
                is_pos = False
            elif od_thresh_upper is not None and c['od'] > od_thresh_upper:
                is_pos = False
            if is_pos:
                num_pos += 1
                label = LABEL_BORDER_POS
            else:
                num_neg += 1
                label = LABEL_BORDER_NEG
            for b in make_full_contour(c['boundary']):
                mask[b[1], b[0]] = label

    mark_background(mask)
    fill_cells(mask)
    create_outer_boundary(mask)
    enlarge_cell_boundaries(mask)
    enlarge_cell_boundaries(mask)
    overlay, refined = create_final_images(np.array(orig), mask)

    num_total = num_pos + num_neg
    scoring = {
        'num_total': num_total,
        'num_pos': num_pos,
        'num_neg': num_neg,
        'percent_pos': round(num_pos / num_total * 100, 1) if num_pos > 0 else 0,
        'seg_thresh': data['settings']['seg_thresh'],
        'size_thresh': size_thresh,
        'size_thresh_upper': size_thresh_upper,
        'marker_thresh': marker_thresh,
    }
    return overlay, refined, scoring
