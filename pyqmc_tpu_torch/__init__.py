"""pyqmc_tpu_torch: the PyTorch/CUDA port of pyqmc_tpu (real-space QMC).

The JAX package `pyqmc_tpu` is the reference; this package mirrors its
module names and holds every ported piece against it. It imports torch and
never jax.

Precision policy (counterpart of pyqmc_tpu/__init__.py): local energies are
sums of large cancelling terms, and low-precision matmuls bias them (+0.7 Ha
observed with bf16 inputs on all-electron H2O). Float32 matmuls therefore run
in full float32 on the GPU: TF32 is switched off for matmuls and for cuDNN.
Parity with the JAX package is checked in float64; float32 is the production
dtype on the card.
"""

import torch as _torch

_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
