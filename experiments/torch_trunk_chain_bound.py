"""What chip_smoke.py's bf16 9-block chain bound (``within_chain_bound``:
accuracy against the float32 chain) admits: the port's bf16 trunk kernel
against its controls, each beside the plain version, on one CUDA card:

* per conv, on chip_smoke.py's own bf16 check inputs (the same seed and
  draws): max error in bf16 ulps, the share of outputs whose bf16 value
  differs from the plain version's, stats error, for the kernel and the
  exact control (``exact_conv``: summed in float64, rounded once);
* the 9-block resblock chain (chip_smoke.py's chain inputs) through the
  kernel, the exact control and the round-toward-zero control
  (``biased_conv``): mean |delta| from the float32 chain over its mean |y|,
  beside the plain chain's and chip_smoke.py's margin, and max |delta| from
  the plain chain.

    python3 experiments/torch_trunk_chain_bound.py

Prints one JSON line per measurement, then the card's name and power limit.
Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit('the chain-bound measurement needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.ops import fused_resblock as FR
    M.configure_device(torch.device('cuda'))   # TF32 off for the plain conv
    convs = {'kernel': FR.conv3x3_stats, 'exact': smoke.exact_conv(FR)}
    plain = FR.conv3x3_stats_reference

    # chip_smoke.py's draws: its float32 checks first, then the bf16 ones
    rnd = smoke.Rand(smoke.SEED)
    s, h, w, c = smoke.KERNEL_SHAPE
    rnd(*smoke.KERNEL_SHAPE), rnd(3, 3, c, c, std=0.02)
    rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    rnd.blocks(c, 9, torch.float32)
    x = rnd(*smoke.KERNEL_SHAPE).to(torch.bfloat16)
    wt = rnd(3, 3, c, c, std=0.02).to(torch.bfloat16)
    sc, bi = rnd(s, c, std=0.1, mean=1.0), rnd(s, c, std=0.1)
    blocks = rnd.blocks(c, 9, torch.bfloat16)

    for padding in ('zero', 'reflect'):
        for affine in (False, True):
            kw = dict(padding=padding, in_relu=affine,
                      in_scale=sc if affine else None,
                      in_bias=bi if affine else None)
            y_ref, st_ref = plain(x, wt, **kw)
            row = {'phase': 'conv_vs_plain', 'shape': list(x.shape),
                   'padding': padding, 'affine_relu': affine}
            for name, conv in convs.items():
                y, st = conv(x, wt, **kw)
                ulps, err = smoke.bf16_ulps(y, y_ref)
                row[name] = {
                    'max_err_in_ulps': ulps, 'max_abs_err_y': err,
                    'outputs_differing': (y != y_ref).float().mean().item(),
                    'stats_rel_err': smoke.stats_rel(st, st_ref)}
            print(json.dumps(row), flush=True)

    for padding in ('zero', 'reflect'):
        dist, vs_plain = smoke.bf16_chain_accuracy(
            FR, x, blocks, padding, dict(convs, biased=smoke.biased_conv(FR)))
        print(json.dumps({
            'phase': 'resblock_chain_vs_float32', 'blocks': 9,
            'padding': padding, 'mean_rel_vs_float32': dist,
            'ratio_to_plain': {k: v / dist['plain'] for k, v in dist.items()},
            'within_bound': {k: smoke.within_chain_bound(dist, k)
                             for k in vs_plain},
            'margin': smoke.CHAIN_F32_MARGIN, 'max_rel_vs_plain': vs_plain,
            'max_bound': smoke.BF16_CHAIN_MAX}), flush=True)
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
