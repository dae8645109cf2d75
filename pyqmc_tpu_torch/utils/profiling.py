"""Timing helpers (counterpart of pyqmc_tpu/utils/profiling.py).

PyTorch returns from a CUDA call before the device finishes, so a host
clock read needs a synchronise first.
"""

from __future__ import annotations

import torch


def sync(device=None):
    """Wait for all queued work on a CUDA device; no-op on the CPU."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)

