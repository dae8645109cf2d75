"""Timing and tracing helpers (counterpart of pyqmc_tpu/utils/profiling.py).

PyTorch returns from a CUDA call before the device finishes, so a host
clock read needs a synchronise first. `trace(logdir)` records a
torch.profiler trace (host operations, and on a GPU the device's kernels
and copies) of what runs inside it and writes it under `logdir` as a
Chrome trace file; vmc and rundmc take it for `profile_dir`, around their
first block. `median_time` and `measure_phase_split` time whole calls with
the device synchronised around each; vmc(profile_phases=True) takes the
split of a block into moves and accumulators from them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
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


def median_time(fn, *args, nrep: int = 3):
    """The median host time of fn(*args) over `nrep` calls after a first
    one (which builds and warms up), the device synchronised before and
    after each call."""
    fn(*args)
    sync()
    times = []
    for _ in range(nrep):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def measure_phase_split(block_fn, move_only_fn, args, nrep: int = 3):
    """{"block time", "move time", "accumulate time"}: the median times of
    a block and of the same block built without accumulators, on the same
    arguments; the accumulate share is their difference (not below 0)."""
    t_full = median_time(block_fn, *args, nrep=nrep)
    t_move = median_time(move_only_fn, *args, nrep=nrep)
    return {"block time": t_full, "move time": min(t_move, t_full),
            "accumulate time": max(t_full - t_move, 0.0)}
