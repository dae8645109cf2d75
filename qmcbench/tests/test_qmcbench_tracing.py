"""The trace's summary: device intervals that overlap count once, and each
idle stretch goes to the host operation under it."""

import pytest
from torch.autograd import DeviceType

from qmcbench import tracing


class _Event:
    def __init__(self, name, start, end, device):
        self._name, self._start, self._dur = name, start, end - start
        self._dev = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._dev


def test_union_of_device_intervals_and_idle_by_host_operation():
    events = [
        _Event("aten::mul", 0, 100, False),       # the host launching the first two
        _Event("void pq::sweep_kernel<float>", 10, 60, True),
        _Event("void at::gemm", 40, 80, True),    # overlaps the first: counted once
        _Event("aten::cat", 90, 130, False),      # under the gap 80-120
        _Event("void at::cat_copy", 120, 150, True),
    ]
    s = tracing.Summary(events)
    assert s.device_events == 3
    assert s.busy_s == pytest.approx((80 - 10 + 150 - 120) * 1e-9)
    assert s.kernel(("pq::sweep_kernel",)) == (1, pytest.approx(50e-9))
    assert dict(s.idle_gaps) == pytest.approx({"aten::mul": 10e-9, "aten::cat": 40e-9})
    assert [name for name, _ in s.device_ops()] == ["void pq::sweep_kernel<float>",
                                                    "void at::gemm", "void at::cat_copy"]
