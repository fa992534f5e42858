"""The int8 (ResNet-trunk scope) sessions of the port against the JAX
engine on the CPU, with per-chunk dynamic scales and with static scales
from a synthetic act_scales.json, and one int8 translator's trunk and tail
from the same trunk input. Model dir, JAX settings and tolerances: see
test_torch_port_precision_slice.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepliif_tpu import models as M_jax
from deepliif_tpu.nets import layers as L_jax
from deepliif_tpu.ops import fused_resblock as FR_jax
from deepliif_tpu_torch import models as M
from test_torch_port_precision_slice import (  # noqa: F401  (fixtures)
    _assert_u8_close, infer_modalities_vs_jax, jax_fused, model_dirs,
    run_tiles_vs_jax)


@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
def test_int8_run_tiles_matches_jax(model_dirs, jax_fused, static):
    run_tiles_vs_jax(model_dirs[static], 'int8', static)


def test_int8_infer_modalities_matches_jax(model_dirs, jax_fused):
    infer_modalities_vs_jax(model_dirs[False], 'int8')


def _jax_trunk_tail(p, h, n_blocks, dynamic):
    """resnet.apply's fused int8 trunk and its tail (zero padding), from
    the trunk input h."""
    blocks = [{f'w{j}q': p[f'res{i}_conv{j}']['w_q'] for j in (1, 2)}
              for i in range(n_blocks)]
    for i, b in enumerate(blocks):
        for j in (1, 2):
            b[f'w{j}s'] = p[f'res{i}_conv{j}']['w_s']
            b[f'a{j}'] = p[f'res{i}_conv{j}'].get('a_s', 1.0)
            b[f'norm{j}'] = p[f'res{i}_norm{j}']
    x = FR_jax.resblock_chain_int8(h, blocks, padding='zero', interpret=True,
                                   dynamic=dynamic)
    for i in range(2):
        x = L_jax.conv_transpose2d(x, p[f'up{i}_conv'], 2, 1, 1)
        x = L_jax.relu(L_jax.apply_norm(x, p[f'up{i}_norm'], 'batch', False))
    x = L_jax.conv2d(L_jax.pad2d(x, 3, 'zero'), p['tail_conv'], 1, 0)
    return jnp.tanh(x)


@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
def test_int8_translator_trunk_matches_jax(model_dirs, jax_fused, static):
    """Translator 0 of the int8 sessions, from the same bf16 trunk input:
    the port's trunk (plain int8 chain) and tail vs the JAX fused int8
    chain in interpret mode and its tail."""
    md = model_dirs[static]
    p = jax.tree_util.tree_map(
        lambda a: a[0], M_jax.InferenceSession(md, n_devices=1,
                                               precision='int8').params['G'])
    net = M.InferenceSession(md, device='cpu', precision='int8',
                             int8_scope='resblocks').nets.G[0]
    h = np.random.default_rng(3).normal(0, 1, (2, 32, 16, 128))
    h = jnp.asarray(np.maximum(h, 0), jnp.bfloat16)
    with jax.disable_jit():
        ref = _jax_trunk_tail(p, h, 2, not static)
    with torch.no_grad():
        got = net.tail(net.trunk(torch.from_numpy(
            np.array(h.astype(jnp.float32))).to(torch.bfloat16)))

    def u8(y):
        return ((np.asarray(y, np.float32) + 1.0) * 127.5).astype(np.uint8)
    _assert_u8_close(u8(got.float().permute(0, 2, 3, 1).numpy()),
                     u8(ref.astype(jnp.float32)), 'trunk')


