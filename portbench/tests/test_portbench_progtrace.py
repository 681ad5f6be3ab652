"""The reduction of a profiled stretch to the program's spans
(``progtrace.py``), on stand-in events, and one stretch of the cell driven
on the CPU at a small size."""

import pytest

from portbench import progtrace
from portbench.tests.conftest import QUICK_SOLVE

WORKLOAD = "centroidal-solve-b2048"


class Event:
    """A stand-in for a kineto event: `kind` "span" (a program span on the
    host), "mark" (its mirror on the device), "op" or "call" (host), or
    "dev" (device work or a sync record)."""

    class _Type:
        def __init__(self, name):
            self.name = name

    def __init__(self, kind, name, start, end, corr=0):
        self._n, self._s, self._e, self._c = name, start, end, corr
        self._k = kind
        self._d = self._Type("CUDA" if kind in ("dev", "mark") else "CPU")

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._k in ("span", "mark")

    def activity_type(self):
        return {"span": "user_annotation", "mark": "gpu_user_annotation",
                "op": "cpu_op", "call": "cuda_runtime",
                "dev": "kernel"}[self._k]


def stretch():
    """One solve: condense.build [100, 400] and pdip.pdip_solve [500, 900]
    inside sqp.solve_mpc [0, 1000]; one launch after the solve."""
    return [
        Event("span", "sqp.solve_mpc", 0, 1000),
        Event("span", "condense.build", 100, 400),
        Event("span", "pdip.pdip_solve", 500, 900),
        Event("mark", "condense.build", 100, 400),       # no device work
        Event("mark", "sqp.solve_mpc", 0, 1000),
        Event("op", "aten::linalg_eigh", 150, 300),
        Event("call", "cudaLaunchKernel", 120, 125, corr=1),
        Event("call", "cudaStreamSynchronize", 200, 290, corr=7),
        Event("dev", "cudaStreamSynchronize", 200, 290, corr=7),
        Event("call", "cudaLaunchKernel", 510, 515, corr=2),
        Event("call", "cudaMemcpyAsync", 520, 525, corr=4),
        Event("op", "aten::mul", 700, 800),
        Event("call", "cudaLaunchKernel", 950, 955, corr=3),
        Event("call", "cudaLaunchKernel", 1100, 1105, corr=5),
        Event("dev", "eigh_kernel", 130, 200, corr=1),
        Event("dev", "gemm", 520, 600, corr=2),
        Event("dev", "Memcpy HtoD (Pageable -> Device)", 600, 610, corr=4),
        Event("dev", "add", 960, 990, corr=3),
        Event("dev", "late", 1200, 1250, corr=5),
        Event("dev", "orphan", 1300, 1301, corr=99),     # no launch call
    ]


def test_attribution_by_correlation_to_the_innermost_span():
    p = progtrace.summarize(stretch())
    sp = p["spans"]
    assert sp["condense.build"]["device_s"] == pytest.approx(70e-9)
    assert sp["pdip.pdip_solve"]["device_s"] == pytest.approx(90e-9)
    # a span holds its children's
    assert sp["sqp.solve_mpc"]["device_s"] == pytest.approx(190e-9)
    assert sp["sqp.solve_mpc"]["self_device_s"] == pytest.approx(30e-9)
    assert sp["(no span)"]["device_s"] == pytest.approx(50e-9)
    assert p["stretch"]["unattributed_device_s"] == pytest.approx(1e-9)
    assert p["stretch"]["device_s"] == pytest.approx(241e-9)
    assert [sp[k]["launches"] for k in ("sqp.solve_mpc", "condense.build",
                                        "pdip.pdip_solve")] == [3, 1, 1]
    assert p["stretch"]["launches"] == 4
    assert sp["pdip.pdip_solve"]["h2d_copies"] == 1
    assert sp["sqp.solve_mpc"]["h2d_copies"] == 1
    assert sp["condense.build"]["count"] == 1


def test_sync_calls_are_counted_and_placed():
    p = progtrace.summarize(stretch())
    assert p["stretch"]["syncs"] == 1
    assert p["spans"]["condense.build"]["syncs"] == 1
    assert p["spans"]["sqp.solve_mpc"]["syncs"] == 1
    assert p["spans"]["pdip.pdip_solve"]["syncs"] == 0
    assert p["sync_sites"] == {"condense.build/aten::linalg_eigh": 1}


def test_user_annotations_are_no_busy_time():
    p = progtrace.summarize(stretch())
    # [130, 200] + [520, 610] + [960, 990] + [1200, 1250] + [1300, 1301]
    assert p["stretch"]["busy_s"] == pytest.approx(241e-9)
    assert p["stretch"]["idle_s"] == pytest.approx(1301e-9 - 130e-9
                                                   - 241e-9)


def test_gaps_are_named_by_span_and_op():
    p = progtrace.summarize(stretch())
    gaps = dict(p["idle_gaps"])
    assert gaps["condense.build/between ops"] == pytest.approx(320e-9)
    assert gaps["pdip.pdip_solve/aten::mul"] == pytest.approx(350e-9)
    assert gaps["host, between ops"] == pytest.approx(260e-9)  # outside
    assert p["spans"]["condense.build"]["idle_s"] == pytest.approx(320e-9)
    assert p["spans"]["sqp.solve_mpc"]["idle_s"] == pytest.approx(670e-9)


def test_metrics_of_spans_and_counters():
    p = progtrace.summarize(stretch())
    m = progtrace.metrics(p, {"line_search.rejected": 3,
                              "line_search.rows": 12, "pdip.guarded": 0,
                              "pdip.steps": 96}, solves=1)
    assert m["condense.device_share"] == pytest.approx(100 * 70 / 190)
    assert m["pdip.device_share"] == pytest.approx(100 * 90 / 190)
    assert m["line_search.device_share"] is None     # no such span here
    assert m["solve.host_syncs"] == 1
    assert m["line_search.rejected_share"] == pytest.approx(25.0)
    assert m["pdip.guarded_share"] == 0.0
    assert set(progtrace.metrics({}, {}, 1).values()) == {None}


def test_a_stretch_without_spans():
    events = [e for e in stretch() if not e.is_user_annotation()]
    p = progtrace.summarize(events)
    assert set(p["spans"]) == {"(no span)"}
    assert p["sync_sites"] == {"(no span)/aten::linalg_eigh": 1}


def test_cell_stretch_on_the_cpu():
    out = progtrace.run(WORKLOAD, 2**31 + 7, steps=1, device="cpu",
                        mix_overrides=QUICK_SOLVE)
    m = out["metrics"]
    assert set(m) == {"condense.device_share", "pdip.device_share",
                      "line_search.device_share", "solve.host_syncs",
                      "line_search.rejected_share", "pdip.guarded_share"}
    assert 0.0 <= m["line_search.rejected_share"] <= 100.0
    assert 0.0 <= m["pdip.guarded_share"] <= 100.0
    # no device on the CPU: the device's numbers have nothing to read
    assert m["condense.device_share"] is None
    assert out["counters"]["line_search.rows"] == 16 * 3
    sp = out["program"]["spans"]
    assert sp["sqp.solve_mpc"]["count"] == 1
    assert sp["condense.build"]["count"] == 3
