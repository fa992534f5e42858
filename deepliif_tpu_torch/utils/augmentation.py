"""Dataset augmentation + offline dataset builders: the port's copy of
deepliif_tpu/utils/augmentation.py (host only; ``imadjust`` is the port's
``postprocessing.imadjust``).

Functional equivalents of the reference offline tooling
(/root/reference/Image_Processing/Augmentation.py:8-84 and
Image_Processing_Helper_Functions.py:18-200): coupled augmentation of paired
stain images (elastic affine -> zoom -> 90-degree rotations, applied with the
same random draw to every modality of an example), H&E/DAB stain
deconvolution, and builders that stitch per-stain files into the aligned
training-row format.
"""

from __future__ import annotations

import os
import random as _random

import numpy as np
from PIL import Image


class Augmentation:
    """Coupled augmentation: one random draw applied to all modality images
    of an example (dict name -> HWC uint8 array)."""

    def __init__(self, images, tile_size=512, rng=None):
        self.images = {k: np.asarray(v) for k, v in images.items()}
        self.shape = next(iter(self.images.values())).shape
        self.rng = rng or np.random.RandomState(None)
        self.pyrng = _random.Random(int(self.rng.randint(0, 2 ** 31)))
        self.rotation_angle = int(self.rng.choice([0, 90, 180, 270]))
        self.alpha_affine = 0.1
        self.tile_size = tile_size

    def pipeline(self):
        self.elastic_transform()
        self.zoom()
        self.rotate()
        return self.images

    def zoom(self):
        """Random crop keeping >= 75% of the image, resized back."""
        import cv2
        h = self.shape[0]
        new_size = self.pyrng.randint(int(h * 0.75), h)
        sy = self.pyrng.randint(0, self.shape[0] - new_size)
        sx = self.pyrng.randint(0, self.shape[1] - new_size)
        for k, img in self.images.items():
            crop = img[sy:sy + new_size, sx:sx + new_size]
            self.images[k] = cv2.resize(crop, (self.tile_size, self.tile_size))

    def rotate(self):
        k = self.rotation_angle // 90
        if k:
            self.images = {key: np.rot90(img, k).copy()
                           for key, img in self.images.items()}

    def elastic_transform(self):
        """Random affine from three perturbed control points (Simard-style
        elastic deformation, affine component)."""
        import cv2
        h, w = self.shape[:2]
        alpha = w * self.alpha_affine
        center = np.float32([h // 2, w // 2])
        sq = min(h, w) // 3
        pts1 = np.float32([center + sq,
                           [center[0] + sq, center[1] - sq],
                           center - sq])
        pts2 = pts1 + self.rng.uniform(-alpha, alpha, pts1.shape).astype(np.float32)
        mat = cv2.getAffineTransform(pts1, pts2)
        for k, img in self.images.items():
            self.images[k] = cv2.warpAffine(
                img, mat, (w, h), borderMode=cv2.BORDER_REFLECT_101)


def stain_deconvolution(ihc_rgb):
    """Separate an IHC image into Hematoxylin / Eosin / DAB channels via the
    Ruifrok-Johnston color deconvolution (skimage rgb2hed equivalent; skimage
    absent in this environment). Returns (H, E, D) float arrays."""
    rgb = np.asarray(ihc_rgb, np.float64) / 255.0
    rgb = np.clip(rgb, 1e-6, 1.0)
    # stain matrix (rows: H, E, DAB unit OD vectors)
    m = np.array([[0.65, 0.70, 0.29],
                  [0.07, 0.99, 0.11],
                  [0.27, 0.57, 0.78]])
    m = m / np.linalg.norm(m, axis=1, keepdims=True)
    od = -np.log10(rgb)
    hed = od.reshape(-1, 3) @ np.linalg.inv(m)
    hed = hed.reshape(od.shape)
    return hed[..., 0], hed[..., 1], hed[..., 2]


def create_training_dataset_from_stains(
        input_dir, output_dir,
        post_fix_names=('IHC', 'DAPI', 'Hema', 'Lap2', 'Marker', 'Seg'),
        subsets=None, tile_size=512, seed=0):
    """Stitch per-stain tile files <name>_<stain>.png into aligned rows and
    split into train/val/test subsets (reference helper :18-88)."""
    subsets = subsets or {'train': 0.7, 'val': 0.15, 'test': 0.15}
    rng = _random.Random(seed)
    for sub in subsets:
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)
    base = post_fix_names[0]
    names = sorted(f for f in os.listdir(input_dir) if f'_{base}.' in f)
    count = 0
    for fn in names:
        stem = fn.split(f'_{base}.')[0]
        ext = fn.rsplit('.', 1)[1]
        tiles = []
        ok = True
        for stain in post_fix_names:
            p = os.path.join(input_dir, f'{stem}_{stain}.{ext}')
            if not os.path.exists(p):
                ok = False
                break
            tiles.append(np.asarray(Image.open(p).convert('RGB').resize(
                (tile_size, tile_size), Image.BICUBIC)))
        if not ok:
            continue
        row = np.concatenate(tiles, axis=1)
        r = rng.random()
        acc = 0.0
        chosen = list(subsets)[-1]
        for sub, frac in subsets.items():
            acc += frac
            if r < acc:
                chosen = sub
                break
        Image.fromarray(row).save(os.path.join(output_dir, chosen, f'{stem}.png'))
        count += 1
    return count


def augment_dataset(input_dir, output_dir, aug_no=9, tile_size=512, seed=0):
    """Write aug_no coupled-augmented copies of each aligned row
    (reference augment_created_dataset :134-164)."""
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    count = 0
    for fn in sorted(os.listdir(input_dir)):
        if not fn.endswith('.png'):
            continue
        row = np.asarray(Image.open(os.path.join(input_dir, fn)).convert('RGB'))
        h = row.shape[0]
        num = row.shape[1] // h
        tiles = {i: row[:, i * h:(i + 1) * h] for i in range(num)}
        Image.fromarray(row).save(os.path.join(output_dir, fn))
        for a in range(aug_no):
            aug = Augmentation(dict(tiles), tile_size=h, rng=rng)
            out = aug.pipeline()
            new_row = np.concatenate([out[i] for i in range(num)], axis=1)
            stem = fn.rsplit('.', 1)[0]
            Image.fromarray(new_row).save(
                os.path.join(output_dir, f'{stem}_aug{a}.png'))
            count += 1
    return count


# ---------------------------------------------------------------------------
# WSI / multichannel-OME -> training-set builders (reference
# Image_Processing_Helper_Functions.py:166-180, 451-521)
# ---------------------------------------------------------------------------

# ONE imadjust definition for the whole package (guards constant input)
from ..postprocessing import imadjust  # noqa: F401,E402


def create_dataset_from_wsi_regions(region_images, output_dir, name,
                                    tile_size=1024, start_i=0, start_j=0):
    """Tile a dict of per-modality region arrays into per-modality PNGs,
    skipping tiles whose DAPI content is empty (reference
    create_dataset_from_WSI_regions, :503-521). File naming
    '<name>_<y>_<x>_<modality>.png' matches the reference."""
    import os
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    shape = next(iter(region_images.values())).shape
    n = 0
    for y0 in range(0, shape[0] - tile_size + 1, tile_size):
        for x0 in range(0, shape[1] - tile_size + 1, tile_size):
            dapi = region_images.get('DAPI')
            if dapi is not None:
                dt = dapi[y0:y0 + tile_size, x0:x0 + tile_size]
                if not dt.any():   # empty DAPI tile (unsigned data:
                    continue       # any() False <=> mean 0)
            for img_type, region in region_images.items():
                tile = region[y0:y0 + tile_size, x0:x0 + tile_size]
                tile = imadjust(tile, 1, 0, 255).astype(np.uint8)
                Image.fromarray(tile).save(os.path.join(
                    output_dir,
                    f'{name}_{start_i + y0}_{start_j + x0}_{img_type}.png'))
            n += 1
    return n


def create_dataset_from_multichannel_ome(ome_dir, output_dir, tile_size=1024,
                                         img_channel_modality=None,
                                         region_size=10240):
    """Build a tile dataset from a directory of multichannel OME TIFFs
    (reference create_dataset_from_ome_multi_channel_image, :451-500 — there
    via Bio-Formats/JVM; here via utils.tiff.TiledTiffReader channel pages).

    img_channel_modality: {'DAPI': 0, 'IHC': [2, 3, 4], ...} — a list value
    stacks channels into an RGB image.
    """
    import os
    from .tiff import TiledTiffReader

    if not img_channel_modality:
        raise ValueError('img_channel_modality is required, e.g. '
                         "{'DAPI': 0, 'IHC': [2, 3, 4]}")
    os.makedirs(output_dir, exist_ok=True)
    total = 0
    for ome in sorted(os.listdir(ome_dir)):
        if not ome.lower().endswith(('.tif', '.tiff')):
            continue
        reader = TiledTiffReader(os.path.join(ome_dir, ome))
        w, h = reader.size
        name = ome.split('_')[0].rsplit('.', 1)[0]
        for i in range(0, h, region_size):
            for j in range(0, w, region_size):
                rh = min(region_size, h - i)
                rw = min(region_size, w - j)
                images = {}
                for img_type, chans in img_channel_modality.items():
                    if isinstance(chans, (list, tuple)):
                        planes = [reader.read_region(j, i, rw, rh,
                                                     level=ch)[:, :, 0]
                                  for ch in chans]
                        images[img_type] = np.dstack(planes)
                    else:
                        images[img_type] = reader.read_region(
                            j, i, rw, rh, level=chans)[:, :, 0]
                total += create_dataset_from_wsi_regions(
                    images, output_dir, name, tile_size, start_i=i, start_j=j)
        reader.close()
    return total
