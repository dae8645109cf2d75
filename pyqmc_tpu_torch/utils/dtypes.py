"""Dtype defaults (counterpart of pyqmc_tpu/utils/dtypes.py).

The port is dtype-agnostic: hot-path tensors take their dtype from the
inputs. float64 is the parity dtype (CPU tests against the JAX package);
float32 is the production dtype on the GPU.
"""

import torch

PARITY_DTYPE = torch.float64
PRODUCTION_DTYPE = torch.float32


class NoCudaDeviceError(RuntimeError):
    """An entry point was left to its default device and there is no GPU."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, or the GPU when
    none is given. Without a GPU the default raises NoCudaDeviceError; the
    CPU is taken only when the caller writes device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            'no CUDA device: the port runs on the GPU by default; pass device="cpu" '
            "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def real_dtype(device) -> torch.dtype:
    """float32 on a CUDA device, float64 elsewhere."""
    return PRODUCTION_DTYPE if torch.device(device).type == "cuda" else PARITY_DTYPE
