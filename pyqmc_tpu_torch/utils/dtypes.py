"""Dtype defaults (counterpart of pyqmc_tpu/utils/dtypes.py).

The port is dtype-agnostic: hot-path tensors take their dtype from the
inputs. float64 is the parity dtype (CPU tests against the JAX package);
float32 is the production dtype on the GPU.
"""

import numpy as np
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


def int_dtype(dtype_or_device) -> torch.dtype:
    """The integer dtype beside a precision: int32 beside float32 (or
    complex64, or a CUDA device, where float32 is the default), int64
    beside float64 and elsewhere."""
    if isinstance(dtype_or_device, torch.dtype):
        single = dtype_or_device in (torch.float32, torch.complex64)
    else:
        single = real_dtype(dtype_or_device) == torch.float32
    return torch.int32 if single else torch.int64


def complex_dtype(dtype) -> torch.dtype:
    """The complex dtype of a real (or complex) dtype's precision:
    complex64 for float32, complex128 for float64."""
    if dtype.is_complex:
        return dtype
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def is_complex(x) -> bool:
    """True for a complex tensor, array or number."""
    return x.is_complex() if isinstance(x, torch.Tensor) else bool(np.iscomplexobj(x))
