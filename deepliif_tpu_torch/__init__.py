"""DeepLIIF on PyTorch and CUDA: the port of deepliif_tpu to an NVIDIA
Hopper GPU.

The JAX package ``deepliif_tpu`` stays as the reference this package is held
against. Module names mirror it (``nets/resnet.py``, ``ops/fused_resblock.py``,
...). Plain layers run on stock PyTorch; each TPU Pallas kernel on a ported
path becomes a hand-written CUDA kernel under ``csrc/``, built with nvcc at
first use. Host modules that never import JAX (``deepliif_tpu.config``,
``deepliif_tpu.utils``, ``deepliif_tpu.utils.tiler``,
``deepliif_tpu.postprocessing``) are imported from ``deepliif_tpu``, not
copied. This package never imports jax.
"""

__version__ = "0.1.0"
