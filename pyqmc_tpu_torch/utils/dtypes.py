"""Dtype defaults (counterpart of pyqmc_tpu/utils/dtypes.py).

The port is dtype-agnostic: hot-path tensors take their dtype from the
inputs. float64 is the parity dtype (CPU tests against the JAX package);
float32 is the production dtype on the GPU.
"""

import torch

PARITY_DTYPE = torch.float64
PRODUCTION_DTYPE = torch.float32


def real_dtype(device) -> torch.dtype:
    """float32 on a CUDA device, float64 elsewhere."""
    return PRODUCTION_DTYPE if torch.device(device).type == "cuda" else PARITY_DTYPE
