"""VGG19 feature extractor for the perceptual (feature-matching) loss, the
port of deepliif_tpu/nets/vgg.py.

The 5-slice split of the reference Vgg19 wrapper (reference
networks.py:698-743): slices end after relu1_1, relu2_1, relu3_1, relu4_1,
relu5_1; loss weights [1/32, 1/16, 1/8, 1/4, 1].

Weights: the converted ``.npz`` that the JAX package reads (``conv{i}_w``
HWIO, ``conv{i}_b``; the path from ``DEEPLIIF_VGG19_WEIGHTS`` or an
argument), else the JAX package's fixed-seed He (kaiming) draw: from
``jax.random.PRNGKey(19)``, a split per conv, std sqrt(2 / fan_in) over
the HWIO shape, zero biases, drawn in numpy by ``utils.jax_random``
(the same network as the JAX package's, to a few float32 ulps).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import jax_random
from ..utils.checkpoints import weight_from_hwio
from . import layers as L

# VGG19's convolutions in the 5 slices (channels per conv)
SLICES = [
    [(3, 64)],                                        # conv1_1
    [(64, 64), 'pool', (64, 128)],                    # conv1_2, pool1, conv2_1
    [(128, 128), 'pool', (128, 256)],                 # conv2_2, pool2, conv3_1
    [(256, 256), (256, 256), (256, 256), 'pool', (256, 512)],  # conv3_2..4, pool3, conv4_1
    [(512, 512), (512, 512), (512, 512), 'pool', (512, 512)],  # conv4_2..4, pool4, conv5_1
]
LOSS_WEIGHTS = [1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0]
SEED = 19


@functools.lru_cache(maxsize=1)
def default_kernels():
    """The JAX package's default draw (``deepliif_tpu/nets/vgg.py`` init
    without weights): HWIO float32 kernels in slice order, drawn once per
    process."""
    key, out = jax_random.PRNGKey(SEED), []
    for sl in SLICES:
        for item in sl:
            if item == 'pool':
                continue
            cin, cout = item
            key, sub = jax_random.split(key)
            std = np.float32((2.0 / (9 * cin)) ** 0.5)
            w = std * jax_random.normal(sub, (3, 3, cin, cout))
            w.setflags(write=False)
            out.append(w)
    return tuple(out)


class VGG19Features(nn.Module):
    """The 16 convolutions of the slices, ``convs[i]`` in slice order, with
    frozen parameters."""

    def __init__(self, weights_path=None):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1)
            for sl in SLICES for item in sl if item != 'pool'
            for cin, cout in [item])
        weights_path = weights_path or os.environ.get('DEEPLIIF_VGG19_WEIGHTS')
        with torch.no_grad():
            if weights_path and os.path.exists(weights_path):
                with np.load(weights_path) as data:
                    for i, conv in enumerate(self.convs):
                        conv.weight.copy_(weight_from_hwio(torch.from_numpy(
                            np.asarray(data[f'conv{i}_w'], np.float32)),
                            'conv'))
                        conv.bias.copy_(torch.from_numpy(
                            np.asarray(data[f'conv{i}_b'], np.float32)))
            else:
                for conv, w in zip(self.convs, default_kernels()):
                    conv.weight.copy_(weight_from_hwio(
                        torch.from_numpy(w.copy()), 'conv'))
                    conv.bias.zero_()
        self.requires_grad_(False)

    def features(self, x):
        """x (N, 3, H, W) in [-1, 1] (network outputs, fed without ImageNet
        renormalization, as the reference does) -> the 5 slice
        activations."""
        outs, ci, h = [], 0, x
        for sl in SLICES:
            for item in sl:
                if item == 'pool':
                    h = F.max_pool2d(h, 2, 2)
                else:
                    conv = self.convs[ci]
                    h = L.relu(L.conv2d(h, conv.weight, conv.bias, 1, 1))
                    ci += 1
            outs.append(h)
        return outs


def vgg_loss(net, x, y):
    """Weighted L1 between the feature slices of x and y (reference
    networks.py:731-743), y's features without gradient. x, y: (N, 3, H,
    W), or (G, N, 3, H, W) for G losses at once (one pass of the G N
    images), returned as (G,)."""
    groups = x.shape[0] if x.dim() == 5 else None
    flat = (lambda t: t.reshape(-1, *t.shape[2:])) if groups else \
        (lambda t: t)
    fx = net.features(flat(x))
    with torch.no_grad():
        fy = net.features(flat(y))
    loss = 0.0
    for w, a, b in zip(LOSS_WEIGHTS, fx, fy):
        d = (a - b).abs()
        loss = loss + w * (d.reshape(groups, -1).mean(1) if groups
                           else d.mean())
    return loss
