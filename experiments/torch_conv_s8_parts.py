"""Where a ``conv_s8`` call's time goes, on one CUDA card: copies of
``deepliif_tpu_torch/csrc/conv_s8.cu`` with pieces compiled out, each
timed at the flagship's calls (``chip_smoke.S8_CALLS``), static and
dynamic scales. The pieces (``-D`` flags of the copy):

- ``NO_LOAD``: the slab producers load nothing (the slab is zeros);
- ``NO_CONVERT``: they store the loaded bf16 bits instead of quantizing;
- ``NO_MMA``: the consumers issue no ``wgmma``;
- ``NO_EPI``: the consumers store no output;
- ``NO_B``: the weights' warp copies no weights.

A copy's output is wrong by design: only its time is read. The gather
mode (the U-Nets' 1-4 pixel levels) is not instrumented. Each copy is
built by nvcc from a copy of the source under ``build/conv_s8_parts/``
(the markers are inserted by text, so this script fails loudly when the
source changes under it) and called through this tree's wrapper.

    python3 experiments/torch_conv_s8_parts.py \\
        [--variants base,NO_MMA,NO_EPI,NO_LOAD+NO_CONVERT] \\
        [--calls 'translator down0,unet up 128']

Prints one JSON line per call (ms by variant and scale), then the card's
name and power limit. Imports nothing of jax or deepliif_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402

CSRC = os.path.join(ROOT, 'deepliif_tpu_torch', 'csrc')
OUT = os.path.join(ROOT, 'build', 'conv_s8_parts')

# (text of the source, the same wrapped in its marker)
MARKS = [
    ("""        if constexpr (DYN) {
          q0 = quant8_qtab(v[r][0], qtab, qbase);
          q1 = quant8_qtab(v[r][1], qtab, qbase);
        } else {
          q0 = quant8<false>(v[r][0], iv0, 0.f);
          q1 = quant8<false>(v[r][1], iv1, 0.f);
        }""", """#ifdef NO_CONVERT
        q0 = make_uint2(v[r][0].x, v[r][0].y);
        q1 = make_uint2(v[r][1].x, v[r][1].y);
        (void)qtab; (void)qbase; (void)iv0; (void)iv1;
#else
        if constexpr (DYN) {
          q0 = quant8_qtab(v[r][0], qtab, qbase);
          q1 = quant8_qtab(v[r][1], qtab, qbase);
        } else {
          q0 = quant8<false>(v[r][0], iv0, 0.f);
          q1 = quant8<false>(v[r][1], iv1, 0.f);
        }
#endif"""),
    ("""        if (ch < P.cin) v[r][0] = __ldg(src);
        if (ch + 8 < P.cin) v[r][1] = __ldg(src + 1);""", """#ifndef NO_LOAD
        if (ch < P.cin) v[r][0] = __ldg(src);
        if (ch + 8 < P.cin) v[r][1] = __ldg(src + 1);
#else
        (void)src;
#endif"""),
    ("""            stage_taps<NTAP, TW, BN>(acc, a_off, b_off, lbo,
                                     L.bstride * 16, c == 0 && ty0 == 0);""",
     """#ifndef NO_MMA
            stage_taps<NTAP, TW, BN>(acc, a_off, b_off, lbo,
                                     L.bstride * 16, c == 0 && ty0 == 0);
#endif"""),
    ("""        const float sn = DYN ? dyn_scale(P.amax[n]) : 0.f;
#pragma unroll
        for (int j = 0; j < TW; ++j) {""", """        const float sn = DYN ? dyn_scale(P.amax[n]) : 0.f;
#ifdef NO_EPI
        if (acc[0][0] != 123456789) continue;
#endif
#pragma unroll
        for (int j = 0; j < TW; ++j) {"""),
    ("""        mbar_arrive_expect_tx(full, rows * f.ntx * BN * KC);
        for (int ty = ty0; ty < ty0 + rows; ++ty)""", """#ifdef NO_B
        mbar_arrive(full);
        for (int ty = ty0; ty < ty0; ++ty)
#else
        mbar_arrive_expect_tx(full, rows * f.ntx * BN * KC);
        for (int ty = ty0; ty < ty0 + rows; ++ty)
#endif"""),
]


def build(variants):
    """{variant: ctypes library} built from the marked copy, one nvcc per
    variant, all started together."""
    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(CSRC):
        if name.endswith('.cuh'):
            shutil.copy(os.path.join(CSRC, name), OUT)
    with open(os.path.join(CSRC, 'conv_s8.cu')) as f:
        src = f.read()
    for plain, marked in MARKS:
        if plain not in src:
            sys.exit(f'conv_s8.cu changed: no marker site for {plain[:60]!r}')
        src = src.replace(plain, marked)
    with open(os.path.join(OUT, 'conv_s8.cu'), 'w') as f:
        f.write(src)
    from deepliif_tpu_torch.ops import cuda_build
    procs = {}
    for v in variants:
        flags = [] if v == 'base' else [f'-D{p}' for p in v.split('+')]
        procs[v] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, '-o',
             os.path.join(OUT, f'lib_{v}.so'), os.path.join(OUT, 'conv_s8.cu')])
    libs = {}
    for v, p in procs.items():
        if p.wait() != 0:
            sys.exit(f'nvcc failed for {v}')
        libs[v] = ctypes.CDLL(os.path.join(OUT, f'lib_{v}.so'))
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--variants',
                    default='base,NO_MMA,NO_EPI,NO_LOAD+NO_CONVERT,'
                            'NO_MMA+NO_EPI,NO_LOAD+NO_CONVERT+NO_MMA+NO_EPI+'
                            'NO_B')
    ap.add_argument('--calls', default='translator down0,translator up0,'
                                       'translator up1,unet up 128,'
                                       'unet up 32')
    ap.add_argument('--iters', type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('the conv_s8 parts need a CUDA card')
    from deepliif_tpu_torch.ops import conv_int8 as C
    variants = args.variants.split(',')
    libs = build(variants)
    ref = C._lib()
    for lib in libs.values():
        for fn in ('conv_s8_split', 'conv_s8_absmax', 'conv_s8'):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = getattr(ref, fn).restype
    rnd = smoke.Rand(smoke.SEED)
    names = args.calls.split(',')
    for name, kind, shape, cout, k, op in smoke.S8_CALLS:
        if name not in names:
            continue
        x = rnd.big(*shape)
        qcs = smoke.s8_conv_params(rnd, x, kind, k, cout)
        run = smoke.s8_call(C, kind, op)
        res = {}
        for v, lib in libs.items():
            C._lib = lambda lib=lib: lib
            for mode, qc in qcs.items():
                res[f'{v} {mode}'] = smoke.cuda_ms(lambda: run(x, qc),
                                                   args.iters)
        C._lib = lambda: ref
        print(json.dumps({'call': name, 'x': list(shape), 'cout': cout,
                          'ms': res}), flush=True)
        del x, qcs
        torch.cuda.empty_cache()
    print(smoke.nvidia_smi())


if __name__ == '__main__':
    main()
