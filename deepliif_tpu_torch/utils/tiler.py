"""Tiling / stitching for large-image inference: the port's own copy of
deepliif_tpu/utils/tiler.py (with the ownership maps of the device-side
stitch).

Geometry parity with the reference InferenceTiler
(reference deepliif/util/__init__.py:129-331): mirror/flip padding for
images smaller than the patch, per-side overlap, row-major tile order with
edge re-alignment (x clamped to width-patch), center-crop stitching with
border/corner special cases, final crop back to the original size.

Instead of an iterator feeding one tile at a time to a Dask graph, tiles
are materialized as ONE (N, ts, ts, C) batch for the batched engine, and
stitching is a vectorized canvas paste on host.
"""

from __future__ import annotations

import numpy as np


def _mirror_pad_axis(a, target, axis):
    """Repeat-mirror an array along axis until >= target, then crop.

    Matches the reference's iterative mirror/flip doubling
    (util/__init__.py:196-208)."""
    while a.shape[axis] < target:
        a = np.concatenate([a, np.flip(a, axis=axis)], axis=axis)
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, target)
    return a[tuple(sl)]


class InferenceTiler:
    """Batched tiler over one image or a list of same-size images (HWC uint8)."""

    def __init__(self, orig, tile_size, overlap_size=0, pad_size=0,
                 pad_color=(255, 255, 255)):
        if tile_size <= 0:
            raise ValueError('tile_size must be positive')
        if overlap_size < 0 or pad_size < 0:
            raise ValueError('overlap_size/pad_size must be >= 0')

        self.single_orig = not isinstance(orig, (list, tuple))
        imgs = [orig] if self.single_orig else list(orig)
        imgs = [np.asarray(im) for im in imgs]
        for im in imgs[1:]:
            if im.shape != imgs[0].shape:
                raise ValueError('input images do not have the same size')

        self.orig_height, self.orig_width = imgs[0].shape[:2]
        patch = tile_size - 2 * pad_size

        # mirror-pad small images up to patch size
        need_w = max(self.orig_width, patch)
        need_h = max(self.orig_height, patch)
        if need_w != self.orig_width:
            imgs = [_mirror_pad_axis(im, patch, 1) for im in imgs]
        if need_h != self.orig_height:
            imgs = [_mirror_pad_axis(im, patch, 0) for im in imgs]
        self.image_height, self.image_width = imgs[0].shape[:2]

        ow = 0 if patch >= self.image_width else overlap_size
        oh = 0 if patch >= self.image_height else overlap_size
        cw = patch - 2 * ow
        ch = patch - 2 * oh
        if cw <= 0 or ch <= 0:
            raise ValueError('combined overlap_size and pad_size are too large')

        # crop offsets in result tiles (c*) and paste offsets (p*), identical
        # to reference util/__init__.py:219-230
        self.c0 = pad_size
        self.c1x, self.c1y = ow + pad_size, oh + pad_size
        self.c2x, self.c2y = patch - ow + pad_size, patch - oh + pad_size
        self.c3 = patch + pad_size
        self.p1x, self.p1y = ow, oh
        self.p2x, self.p2y = patch - ow, patch - oh

        self.patch = patch
        self.tile_size = tile_size
        self.pad_size = pad_size
        self.pad_color = np.asarray(pad_color, imgs[0].dtype)
        self.imgs = imgs

        # tile origin coordinates, row-major with edge clamping
        xs, ys = [], []
        for y in range(0, self.image_height, ch):
            y = min(y, self.image_height - patch)
            for x in range(0, self.image_width, cw):
                x = min(x, self.image_width - patch)
                xs.append(x)
                ys.append(y)
        self.coords = list(zip(xs, ys))
        self.res = {}

    @property
    def num_tiles(self):
        return len(self.coords)

    def tiles(self):
        """All tiles as one (N, tile_size, tile_size, C) batch per input."""
        out = []
        for im in self.imgs:
            t = np.stack([im[y:y + self.patch, x:x + self.patch]
                          for x, y in self.coords])
            if self.pad_size:
                t = np.pad(t, ((0, 0), (self.pad_size,) * 2, (self.pad_size,) * 2,
                               (0, 0)), constant_values=0)
                t[:, :self.pad_size] = self.pad_color
                t[:, -self.pad_size:] = self.pad_color
                t[:, :, :self.pad_size] = self.pad_color
                t[:, :, -self.pad_size:] = self.pad_color
            out.append(t)
        return out[0] if self.single_orig else out

    def __iter__(self):
        """Reference-compatible per-tile iteration (sets current coords)."""
        batches = self.tiles()
        if self.single_orig:
            batches = [batches]
        for i, (x, y) in enumerate(self.coords):
            self.x, self.y = x, y
            tile = [b[i] for b in batches]
            yield tile[0] if self.single_orig else tile

    # -- stitching ----------------------------------------------------------

    def _canvas(self, key, c):
        if key not in self.res:
            self.res[key] = np.zeros(
                (self.image_height, self.image_width, c), np.uint8)
        return self.res[key]

    def _paste(self, key, tile, x, y):
        """Paste one result tile at origin (x, y) with the reference's
        center-crop + border/corner rules (util/__init__.py:286-316)."""
        cv = self._canvas(key, tile.shape[-1])
        c0, c1x, c1y = self.c0, self.c1x, self.c1y
        c2x, c2y, c3 = self.c2x, self.c2y, self.c3
        p1x, p1y, p2x, p2y = self.p1x, self.p1y, self.p2x, self.p2y
        W, H, patch = self.image_width, self.image_height, self.patch

        cv[y + p1y:y + p2y, x + p1x:x + p2x] = tile[c1y:c2y, c1x:c2x]
        if x == 0 and y == 0:
            cv[y:y + c1y - c0, x:x + c1x - c0] = tile[c0:c1y, c0:c1x]
        if y == 0:
            cv[y:y + c1y - c0, x + p1x:x + p2x] = tile[c0:c1y, c1x:c2x]
        if x == W - patch and y == 0:
            cv[y:y + c1y - c0, x + p2x:x + p2x + c3 - c2x] = tile[c0:c1y, c2x:c3]
        if x == 0:
            cv[y + p1y:y + p2y, x:x + c1x - c0] = tile[c1y:c2y, c0:c1x]
        if x == W - patch:
            cv[y + p1y:y + p2y, x + p2x:x + p2x + c3 - c2x] = tile[c1y:c2y, c2x:c3]
        if x == 0 and y == H - patch:
            cv[y + p2y:y + p2y + c3 - c2y, x:x + c1x - c0] = tile[c2y:c3, c0:c1x]
        if y == H - patch:
            cv[y + p2y:y + p2y + c3 - c2y, x + p1x:x + p2x] = tile[c2y:c3, c1x:c2x]
        if x == W - patch and y == H - patch:
            cv[y + p2y:y + p2y + c3 - c2y, x + p2x:x + p2x + c3 - c2x] = tile[c2y:c3, c2x:c3]

    def stitch(self, result_tiles):
        """Stitch a dict of result tiles at the current iteration coords
        (reference-compatible API for the per-tile path)."""
        for k, tile in result_tiles.items():
            tile = np.asarray(tile)
            if tile.shape[0] != self.tile_size:
                from PIL import Image
                tile = np.asarray(Image.fromarray(tile).resize(
                    (self.tile_size, self.tile_size)))
            self._paste(k, tile, self.x, self.y)

    def stitch_batch(self, key, tiles):
        """Stitch a full (N, ts, ts, C) result batch in row-major order."""
        tiles = np.asarray(tiles)
        assert tiles.shape[0] == len(self.coords), (tiles.shape, len(self.coords))
        for (x, y), tile in zip(self.coords, tiles):
            self._paste(key, tile, x, y)

    def ownership_maps(self):
        """Per-pixel tile ownership for the device-side stitch.

        The 9 paste cases of _paste are separable: the owner of canvas pixel
        (Y, X) is (last row band containing Y, last col band containing X)
        in row-major paste order, and the source coordinate within the owner
        tile is simply (Y - y_band, X - x_band). Returns numpy arrays
        (tile_idx (H, W) int32, ty (H,) int32, tx (W,) int32) so
        canvas = tiles[tile_idx, ty[:, None], tx[None, :]] reproduces
        stitch_batch exactly (pad_size 0 path)."""
        if self.pad_size != 0:
            raise ValueError('the device stitch supports pad_size=0 only')
        H, W, patch = self.image_height, self.image_width, self.patch
        ys = sorted({y for _, y in self.coords})
        xs = sorted({x for x, _ in self.coords})

        def owners(origins, p1, p2, size):
            own = np.zeros(size, np.int32)
            for k, o in enumerate(origins):
                start = o if o == 0 else o + p1
                end = o + p2 + ((patch - p2) if o == size - patch else 0)
                own[start:end] = k
            return own

        row_owner = owners(ys, self.p1y, self.p2y, H)
        col_owner = owners(xs, self.p1x, self.p2x, W)
        # tile index of (row band, col band) in self.coords order: coords are
        # row-major over the SAME clamped origins (duplicates collapse to the
        # same origin, identical content)
        index_of = {}
        for i, (x, y) in enumerate(self.coords):
            index_of[(y, x)] = i  # later duplicates overwrite = last paste
        ty = np.empty(H, np.int32)
        tx = np.empty(W, np.int32)
        for Y in range(H):
            ty[Y] = Y - ys[row_owner[Y]]
        for X in range(W):
            tx[X] = X - xs[col_owner[X]]
        lut = np.empty((len(ys), len(xs)), np.int32)
        for r, y in enumerate(ys):
            for c, x in enumerate(xs):
                lut[r, c] = index_of[(y, x)]
        tile_idx = lut[row_owner[:, None], col_owner[None, :]]
        return tile_idx, ty, tx

    def results(self):
        if (self.orig_width, self.orig_height) != (self.image_width, self.image_height):
            return {k: v[:self.orig_height, :self.orig_width]
                    for k, v in self.res.items()}
        return dict(self.res)

