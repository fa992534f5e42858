"""Why a float32 gradient of one DeepLIIF training step misses a float64
reference by percent of some tensors' max on one CUDA card: the layout of
``chip_smoke.train_step_vs_cpu`` (4 resnet_9blocks, 5 unet_128, n_layers-4
discriminators, ngf = ndf = 16, 128^2, batch 2, no dropout, TF32 off), the
generators' gradients of the G loss with the perceptual term's upstream
gradient shared (the card's), each run without shared ReLU branches.

    python3 experiments/torch_train_branch_flips.py

Computes the gradients at float64 on the CPU (the reference), at float32 on
the CPU, and on the card at float32 with cuDNN as the port runs it
(deterministic algorithms), with cuDNN's nondeterministic and benchmarked
algorithms allowed, with cuDNN off (PyTorch's own convs), with the plain
statistics in place of the ``plane_stats`` kernel, and at float64 (plain
statistics). Prints a JSON line per run: the tensors past 1e-3 max|g| +
2 x the CPU float32 run's own miss, the five worst tensors (|Δ| / max|g|
against float64), and each generator ReLU whose input takes the other
branch than in float64 (net, call within the net, positions, the largest
|x| there against the call's max |x|); then the card's name and power
limit. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit('the branch-flip experiment needs a CUDA card')
    from deepliif_tpu_torch import models as M
    from deepliif_tpu_torch.config import Options, TRAIN_DEFAULTS
    from deepliif_tpu_torch.models import deepliif as dl
    from deepliif_tpu_torch.nets import layers as L, vgg
    from deepliif_tpu_torch.ops import cuda_build

    M.configure_device(torch.device('cuda'))
    cuda_build.build(L._LIBS)
    d = dl.DeepLIIFDef(**smoke.TRAIN_STEP_CFG)
    d_rest = dataclasses.replace(d, lambda_feat=0.0)
    opt = Options(d_params=dict(TRAIN_DEFAULTS))
    arrays = smoke.train_batch_arrays(smoke.TRAIN_STEP_SIZE,
                                      smoke.TRAIN_BATCH, d.modalities_no,
                                      smoke.SEED)
    w_feat = d.lambda_feat * torch.tensor(
        d.loss_g_weights[:d.modalities_no], dtype=torch.float64)
    relu, plain_stats = L.relu, L.plane_mean_var
    rec, where = [], ['']

    def recording_relu(x):
        rec.append((where[0], x.detach().double().cpu()))
        return relu(x)

    def grads(dev, dt, up=None, stats_plain=False):
        """{G tensor: gradient}, [(net, ReLU input)], the upstream gradient"""
        if stats_plain:
            L.plane_mean_var = L.plane_mean_var_reference
        try:
            vnet = vgg.VGG19Features().to(dev, dt)
            batch = {k: torch.tensor(v, dtype=dt, device=dev)
                     for k, v in arrays.items()}
            state = dl.create_train_state(d, opt, 1, smoke.SEED, dev)
            state.nets.to(dt)
            for group in ('G', 'GS'):
                for i, net in enumerate(getattr(state.nets, group)):
                    net.register_forward_pre_hook(
                        lambda *_, n=f'{group}.{i}': where.__setitem__(0, n))
            rec.clear()
            L.relu = recording_relu
            try:
                g_out = dl.train_forward(state.nets, batch['A'], d)
            finally:
                L.relu = relu
            inputs = list(rec)
            loss, (_, g_out) = dl.g_loss_fn(state.nets, batch, d_rest, vnet,
                                            g_out=g_out)
            if up is None:
                mods = g_out['mods'].detach().requires_grad_(True)
                up, = torch.autograd.grad((vgg.vgg_loss(
                    vnet, mods.movedim(-1, -3),
                    batch['B_mods'].movedim(-1, -3))
                    * w_feat.to(dev, dt)).sum(), mods)
                up = up.cpu()
            dl.set_grads(state.g_params, loss + (
                g_out['mods'] * up.to(dev, dt)).sum())
            return ({k: v.double() for k, v in smoke.named_grads(state).items()
                     if k.startswith('G')}, inputs, up)
        finally:
            L.plane_mean_var = plain_stats

    card, card_in, up = grads('cuda', torch.float32)
    ref, ref_in, _ = grads('cpu', torch.float64, up)
    cpu, cpu_in, _ = grads('cpu', torch.float32, up)

    def miss(g, k):
        return ((g[k] - ref[k]).abs().max() / ref[k].abs().max()).item()

    def flips(inputs):
        out, seen = [], {}
        for (net, x), (_, want) in zip(inputs, ref_in):
            call = seen[net] = seen.get(net, -1) + 1
            off = (x > 0) != (want > 0)
            if off.any():
                out.append(dict(net=net, relu_call=call,
                                shape=list(x.shape), positions=int(off.sum()),
                                max_abs_x_rel=(want[off].abs().max()
                                               / want.abs().max()).item()))
        return out

    def report(name, g, inputs):
        print(json.dumps(dict(
            run=name,
            past_limit=[(k, miss(g, k), miss(cpu, k)) for k in ref
                        if miss(g, k) > 1e-3 + 2 * miss(cpu, k)],
            worst=sorted(((miss(g, k), k) for k in ref), reverse=True)[:5],
            relu_calls=len(inputs), branch_flips=flips(inputs))), flush=True)

    report('cpu_float32', cpu, cpu_in)
    report('card_float32', card, card_in)
    cudnn = torch.backends.cudnn
    for name, kw, flags in (
            ('card_float32_cudnn_nondeterministic', {},
             dict(deterministic=False)),
            ('card_float32_cudnn_benchmark', {},
             dict(deterministic=False, benchmark=True)),
            ('card_float32_cudnn_off', {}, dict(enabled=False)),
            ('card_float32_plain_statistics', dict(stats_plain=True), {}),
            ('card_float64', dict(stats_plain=True, dt=torch.float64), {})):
        saved = {k: getattr(cudnn, k) for k in flags}
        for k, v in flags.items():
            setattr(cudnn, k, v)
        try:
            g, inputs, _ = grads('cuda', kw.pop('dt', torch.float32), up, **kw)
        finally:
            for k, v in saved.items():
                setattr(cudnn, k, v)
        report(name, g, inputs)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True
    ).stdout.strip())


if __name__ == '__main__':
    main()
