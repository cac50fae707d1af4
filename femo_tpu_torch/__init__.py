"""femo_tpu_torch — the PyTorch/CUDA port of femo_tpu.

The JAX package `femo_tpu` stays the reference; this package mirrors its
tree and names module by module, for one NVIDIA H100 (sm_90a).  Plain
tensor code is PyTorch; the JAX package's Pallas kernels are hand-written
CUDA kernels under `csrc/`, built with nvcc at first use.

This package never imports jax or femo_tpu: the card's machine has no jax.
"""

from .config import config, get_device, set_precision

__version__ = "0.1.0"
