"""The harness's own arithmetic: the reduction of a trace to busy time,
launches and idle gaps; the window's answers kept for the comparison;
the judging of numbers against limits."""

import pytest

from portbench import core, devtrace


class Event:
    """A stand-in for a kineto event of the profiler."""

    class _Type:
        def __init__(self, name):
            self.name = name

    def __init__(self, name, start, end, device):
        self._n, self._s, self._e = name, start, end
        self._d = self._Type("CUDA" if device else "CPU")

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


def test_trace_reduction():
    events = [
        Event("gemm", 0, 100, True), Event("add", 50, 150, True),
        Event("Memcpy HtoD", 300, 350, True),
        Event("cudaStreamSynchronize", 150, 300, True),   # no device work
        Event("cudaLaunchKernel", 0, 5, False),
        Event("cudaLaunchKernel", 40, 45, False),
        Event("aten::bmm", 160, 290, False),
        Event("cudaLaunchKernel", 310, 312, False),
    ]
    s = devtrace.summarize(events)
    assert s["busy_s"] == pytest.approx(200e-9)        # [0, 150] + [300, 350]
    assert s["launches"] == 3
    assert s["kernels"]["gemm"] == {"launches": 1, "seconds": 100e-9}
    assert s["device_ops"][0] == ["gemm", 100e-9]
    assert s["idle_gaps"] == [["aten::bmm", 150e-9]]


def test_ends_keep_the_first_and_the_last():
    e = core.Ends()
    e.add(1)
    assert e.items == [1]
    for i in range(2, 6):
        e.add(i)
    assert e.items == [1, 5]


def test_judge_fails_what_is_missing_or_not_finite():
    got = core.judge({"a": 1e-4, "b": float("nan"), "c": 5.0},
                     {"a": 3e-4, "b": 1.0, "c": 1.0, "d": 1.0})
    assert [got[k]["ok"] for k in "abcd"] == [True, False, False, False]
    assert got["b"]["value"] is None and got["d"]["value"] is None
