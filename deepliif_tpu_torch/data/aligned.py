"""Aligned (paired) dataset over horizontally-stitched training rows: the
port's own copy of the DeepLIIF part of deepliif_tpu/data/aligned.py.

Parity with the reference AlignedDataset (reference
deepliif/data/aligned_dataset.py:7-118): each row image holds the input
tile(s), the modality tiles and the seg tile(s), A | B1..Bm | B_seg; one
shared random crop/flip is applied to all tiles of an example.

Output is NHWC float32 in [-1, 1]: {'A': (H, W, 3), 'B_mods': (M, H, W,
3), 'B_seg': (H, W, 3), 'A_paths': path}. The other families' rows
(DeepLIIFExt, SDG) and the CycleGAN and single-image datasets belong to
the families' training, not ported yet (ROADMAP.md, "Training").
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .. import roadmap
from .transforms import apply_transform, get_params

IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.tif', '.tiff')


def make_dataset(directory, max_size=None):
    paths = []
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if fname.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(root, fname))
    if max_size:
        paths = paths[:max_size]
    return sorted(paths)


class AlignedDataset:
    def __init__(self, opt, phase='train'):
        self.model = getattr(opt, 'model', 'DeepLIIF')
        if self.model not in ('DeepLIIF', 'DeepLIIFKD'):
            raise roadmap.not_ported(f'the {self.model} training rows',
                                     roadmap.TRAINING)
        self.dir_ab = os.path.join(opt.dataroot, phase)
        self.paths = make_dataset(self.dir_ab, getattr(opt, 'max_dataset_size', None))
        if not self.paths:
            raise FileNotFoundError(f'no images found in {self.dir_ab}')
        self.preprocess = getattr(opt, 'preprocess', 'resize_and_crop')
        self.load_size = getattr(opt, 'load_size', 512)
        self.crop_size = getattr(opt, 'crop_size', 512)
        self.no_flip = getattr(opt, 'no_flip', False) or phase != 'train'
        self.modalities_no = opt.modalities_no
        self.seg_no = getattr(opt, 'seg_no', 1)
        self.input_no = getattr(opt, 'input_no', 1)
        self.seg_gen = getattr(opt, 'seg_gen', True)
        self.phase = phase

    def __len__(self):
        return len(self.paths)

    def num_tiles_per_row(self):
        return self.modalities_no + self.seg_no + self.input_no

    def __getitem__(self, index):
        path = self.paths[index]
        ab = Image.open(path).convert('RGB')
        w, h = ab.size
        num_img = self.num_tiles_per_row()
        w2 = w // num_img
        tiles = [ab.crop((w2 * i, 0, w2 * (i + 1), h)) for i in range(num_img)]

        params = get_params(self.preprocess, self.load_size, self.crop_size,
                            tiles[0].size)

        def t(img):
            return apply_transform(img, self.preprocess, self.load_size,
                                   self.crop_size, self.no_flip, params)

        a = [t(tiles[i]) for i in range(self.input_no)]
        a = a[0] if self.input_no == 1 else np.concatenate(a, axis=-1)
        mods = np.stack([t(tiles[self.input_no + i])
                         for i in range(self.modalities_no)])
        out = {'A': a, 'B_mods': mods, 'A_paths': path}
        if self.seg_gen and self.seg_no > 0:
            out['B_seg'] = t(tiles[self.input_no + self.modalities_no])
        return out
