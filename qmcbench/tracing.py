"""The traced window, summarised in the process (a trace of a window holds
hundreds of thousands of events, so it is never written out whole).

`traced` runs torch.profiler (host operations and device activity) around
the window and keeps its raw events; `Summary` reads from them the union of the device's kernel,
copy and set intervals (streams that overlap are counted once), the device
events, device time and launches by name, and the host operation under
each idle stretch of the device.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np

TOP = 10


def _ns(event, which):
    f = getattr(event, f"{which}_ns", None)
    return f() if f is not None else getattr(event, f"{which}_us")() * 1000


@contextlib.contextmanager
def traced(sync):
    """Yields a dict filled, after the block, with `events` (the
    profiler's raw events) and `window_s` (host seconds between the two
    synchronisations)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        sync()
        out["window_s"] = time.perf_counter() - t0
    out["events"] = prof.profiler.kineto_results.events()


class Summary:
    """busy_s, device events and per-name device seconds and launches of a
    traced window's raw events; idle stretches by the host operation under
    them."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in events:
            t0 = _ns(e, "start")
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            if e.device_type() == DeviceType.CUDA:
                dev.append((t0, t0 + dur, e.name()))
            elif e.name().startswith("aten::"):
                host.append((t0, t0 + dur, e.name()))
        self.device_events = len(dev)
        self.by_name = collections.defaultdict(lambda: [0, 0.0])  # name -> [launches, s]
        for a, b, name in dev:
            self.by_name[name][0] += 1
            self.by_name[name][1] += (b - a) * 1e-9
        dev.sort()
        busy, gaps = 0, []
        cur_a = cur_b = None
        for a, b, _ in dev:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                    gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        self.busy_s = busy * 1e-9
        # the device is idle too from the first host operation to its first kernel
        first_host = min((h[0] for h in host), default=None)
        if dev and first_host is not None and first_host < dev[0][0]:
            gaps.insert(0, (first_host, dev[0][0]))
        self.idle_gaps = self._attribute(gaps, host)

    @staticmethod
    def _attribute(gaps, host):
        """[(host operation, idle seconds)] of the longest totals: each gap
        goes to the innermost aten operation running at its midpoint, or
        to "idle" where none is."""
        host = sorted(host)
        starts = np.array([h[0] for h in host], dtype=np.int64)
        totals = collections.defaultdict(float)
        for a, b in gaps:
            mid = (a + b) // 2
            name = "idle"
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            for j in range(i, max(i - 64, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            totals[name] += (b - a) * 1e-9
        return sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]

    def kernel(self, patterns):
        """(launches, device seconds) of the device events whose name holds
        any of `patterns`."""
        n, s = 0, 0.0
        for name, (k, t) in self.by_name.items():
            if any(p in name for p in patterns):
                n += k
                s += t
        return n, s

    def device_ops(self):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
        return [[name[:96], t] for name, (_, t) in top]
