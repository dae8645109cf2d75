"""Host constants copied to a device once.

A blocking host-to-device copy (`torch.as_tensor(array, device="cuda")`)
waits for every kernel already queued on the stream, so a module that
copies its constants on every call stalls the host behind the device. A
`DeviceConstants` holds numpy arrays and hands out tensors cached per
(device, dtype).
"""

from __future__ import annotations

import numpy as np
import torch

from .dtypes import complex_dtype


class DeviceConstants:
    """dc.get(device, dtype)[name] -> the array `name` as a tensor on
    `device`: floating arrays in `dtype`, complex arrays in the complex
    dtype of `dtype`'s precision, integer arrays as int64."""

    def __init__(self, **arrays):
        self._arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self._cache = {}

    def get(self, device, dtype):
        key = (torch.device(device), dtype)
        if key not in self._cache:
            self._cache[key] = {k: torch.as_tensor(a, device=device, dtype=_dtype_of(a, dtype))
                                for k, a in self._arrays.items()}
        return self._cache[key]


def _dtype_of(a, dtype):
    if np.iscomplexobj(a):
        return complex_dtype(dtype)
    return dtype if np.issubdtype(a.dtype, np.floating) else torch.int64


_INDEX = {}


def index_tensor(values, device):
    """A host list of ints as an int64 tensor on `device`, copied once per
    (values, device) and cached."""
    key = (tuple(int(v) for v in values), torch.device(device))
    if key not in _INDEX:
        _INDEX[key] = torch.as_tensor(key[0], dtype=torch.int64, device=device)
    return _INDEX[key]
