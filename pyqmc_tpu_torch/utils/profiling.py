"""Timing and tracing helpers (counterpart of pyqmc_tpu/utils/profiling.py).

PyTorch returns from a CUDA call before the device finishes, so a host
clock read needs a synchronise first. `trace(logdir)` records a
torch.profiler trace (host operations, and on a GPU the device's kernels
and copies) of what runs inside it and writes it under `logdir` as a
Chrome trace file; vmc and rundmc take it for `profile_dir`, around their
first block.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def sync(device=None):
    """Wait for all queued work on a CUDA device; no-op on the CPU."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler trace of the block inside, written to
    logdir/trace_<ns>.json; the device is synchronised before the trace
    stops, so queued kernels land inside it. logdir None: no trace."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))
