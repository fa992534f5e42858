"""DeepLIIF on PyTorch and CUDA: the port of deepliif_tpu to an NVIDIA
Hopper GPU.

The JAX package ``deepliif_tpu`` stays as the reference this package is held
against. Module names mirror it (``nets/resnet.py``, ``ops/fused_resblock.py``,
...). Plain layers run on stock PyTorch; each TPU Pallas kernel on a ported
path becomes a hand-written CUDA kernel under ``csrc/``, built with nvcc at
first use. The host modules it needs (``config``, ``utils.luma_u8``,
``utils.tiler``, ``utils.tiff``, ``serve.dispatch``, ``postprocessing``
with its C++ helper) are its own copies of the JAX package's: this package
imports neither jax nor anything of ``deepliif_tpu``.
"""

__version__ = "0.1.0"
