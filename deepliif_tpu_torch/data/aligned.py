"""The training datasets, the port's own copy of
deepliif_tpu/data/aligned.py.

``AlignedDataset``: paired rows, horizontally stitched (reference
deepliif/data/aligned_dataset.py:7-118); each row image holds the input
tile(s), the modality tiles and the seg tile(s); one shared random
crop/flip is applied to all tiles of an example. Output is NHWC float32
in [-1, 1]:
  DeepLIIF, DeepLIIFKD: A | B1..Bm | B_seg -> {'A': (H, W, 3), 'B_mods':
      (M, H, W, 3), 'B_seg': (H, W, 3)};
  DeepLIIFExt: A | B1..Bm | BS1..BSm -> 'A', 'B_mods' and 'B_segs' (M, H,
      W, 3);
  SDG: A1..An | B1..Bm+1 -> 'A' (H, W, 3 n) and 'B_mods' (M + 1, H, W, 3).
``SingleDataset`` (one-sided images, ``--dataset-mode single``) and
``UnalignedDataset`` (CycleGAN: trainA and trainB1..Bm, the B image drawn
from ``random.Random(seed)``).
"""

from __future__ import annotations

import os
import random

import numpy as np
from PIL import Image

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
        self.model = getattr(opt, 'model', 'DeepLIIF')
        self.phase = phase

    def __len__(self):
        return len(self.paths)

    def num_tiles_per_row(self):
        if self.model in ('DeepLIIF', 'DeepLIIFKD', 'SDG'):
            return self.modalities_no + self.seg_no + self.input_no
        if self.model == 'DeepLIIFExt':
            return (self.modalities_no * 2 + 1 if self.seg_gen
                    else self.modalities_no + 1)
        raise ValueError(f'unsupported model {self.model}')

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

        if self.model in ('DeepLIIF', 'DeepLIIFKD'):
            a = [t(tiles[i]) for i in range(self.input_no)]
            a = a[0] if self.input_no == 1 else np.concatenate(a, axis=-1)
            mods = np.stack([t(tiles[self.input_no + i])
                             for i in range(self.modalities_no)])
            out = {'A': a, 'B_mods': mods, 'A_paths': path}
            if self.seg_gen and self.seg_no > 0:
                out['B_seg'] = t(tiles[self.input_no + self.modalities_no])
            return out

        if self.model == 'DeepLIIFExt':
            a = t(tiles[0])
            mods = np.stack([t(tiles[1 + i]) for i in range(self.modalities_no)])
            out = {'A': a, 'B_mods': mods, 'A_paths': path}
            if self.seg_gen:
                out['B_segs'] = np.stack(
                    [t(tiles[1 + self.modalities_no + i])
                     for i in range(self.modalities_no)])
            return out

        # SDG: the inputs concatenated by channel, M + 1 target tiles
        a = np.concatenate([t(tiles[i]) for i in range(self.input_no)], axis=-1)
        mods = np.stack([t(tiles[self.input_no + i])
                         for i in range(self.modalities_no + 1)])
        return {'A': a, 'B_mods': mods, 'A_paths': path}


class SingleDataset:
    """One-sided image set (reference single_dataset.py:1-40): every image
    under ``dataroot`` as domain A with the standard transform
    (``--dataset-mode single``, CycleGAN one-direction evaluation)."""

    def __init__(self, opt, phase='train'):
        self.a_paths = make_dataset(opt.dataroot,
                                    getattr(opt, 'max_dataset_size', None))
        self.preprocess = getattr(opt, 'preprocess', 'resize_and_crop')
        self.load_size = getattr(opt, 'load_size', 512)
        self.crop_size = getattr(opt, 'crop_size', 512)
        self.no_flip = getattr(opt, 'no_flip', True)

    def __len__(self):
        return len(self.a_paths)

    def __getitem__(self, index):
        path = self.a_paths[index % len(self.a_paths)]
        img = Image.open(path).convert('RGB')
        params = get_params(self.preprocess, self.load_size, self.crop_size,
                            img.size)
        a = apply_transform(img, self.preprocess, self.load_size,
                            self.crop_size, self.no_flip, params)
        return {'A': a, 'A_paths': path}


class UnalignedDataset:
    """CycleGAN data: {phase}A and {phase}B1..Bm, the B image of each
    modality drawn from ``random.Random(opt.seed)`` (in order with
    ``serial_batches``) (reference unaligned_dataset.py:8-90)."""

    def __init__(self, opt, phase='train'):
        self.dataroot = opt.dataroot
        self.modalities_no = opt.modalities_no
        self.phase = phase
        self.dir_a = os.path.join(opt.dataroot, f'{phase}A')
        self.a_paths = make_dataset(self.dir_a, getattr(opt, 'max_dataset_size', None))
        self.b_paths = []
        for i in range(1, self.modalities_no + 1):
            self.b_paths.append(make_dataset(
                os.path.join(opt.dataroot, f'{phase}B{i}'),
                getattr(opt, 'max_dataset_size', None)))
        self.preprocess = getattr(opt, 'preprocess', 'resize_and_crop')
        self.load_size = getattr(opt, 'load_size', 512)
        self.crop_size = getattr(opt, 'crop_size', 512)
        self.no_flip = getattr(opt, 'no_flip', False)
        self.serial_batches = getattr(opt, 'serial_batches', False)
        self.rng = random.Random(getattr(opt, 'seed', None))

    def __len__(self):
        return len(self.a_paths)

    def __getitem__(self, index):
        a_path = self.a_paths[index % len(self.a_paths)]
        a_img = Image.open(a_path).convert('RGB')
        params = get_params(self.preprocess, self.load_size, self.crop_size,
                            a_img.size)

        def t(img):
            return apply_transform(img, self.preprocess, self.load_size,
                                   self.crop_size, self.no_flip, params)

        bs = []
        for i in range(self.modalities_no):
            paths = self.b_paths[i]
            if self.serial_batches:
                b_path = paths[index % len(paths)]
            else:
                b_path = paths[self.rng.randint(0, len(paths) - 1)]
            bs.append(t(Image.open(b_path).convert('RGB')))
        return {'A': t(a_img), 'B_mods': np.stack(bs), 'A_paths': a_path}
