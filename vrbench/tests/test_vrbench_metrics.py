"""The reading of a trace, on a small synthetic list of profiler events:
attribution by the launch link, busy time, idle share, launches and
device time by kind, and the per-layer readers over it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from vrbench import metrics


def ev(name, start, end, dev=False, id=0, linked=0, annotation=False):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), id=id,
        linked_correlation_id=linked, is_user_annotation=annotation)


def trace():
    """Two steps on the host (0-100 us, 100-200 us).  Step 1 launches K1
    at 10 (runs 20-50), a kernel of no kind at 14 (runs 50-55) and Adam's
    kernel at 60 inside Optimizer.step (runs 55-65); step 2 launches K2 at
    110 (runs 120-180), a fill at 112 (runs 180-185) and NCCL at 150 (runs
    175-195, overlapping K2 and the fill).  A copy launched before the steps (its
    launch at -10) is not theirs; an annotation on the device is not an
    entry; a kernel with no runtime call is linked to its operation."""
    return [
        ev(metrics.UNIT, 0, 100), ev(metrics.UNIT, 100, 200),
        ev("Optimizer.step#Adam.step", 58, 70),
        ev("cudaLaunchKernel", 10, 12, id=1),
        ev("march_fwd_kernel", 20, 50, dev=True, id=1),
        ev("cudaLaunchKernel", 14, 15, id=6),
        ev("elementwise_kernel", 50, 55, dev=True, id=6),
        ev("cudaLaunchKernel", 60, 61, id=2),
        ev("multi_tensor_apply_kernel", 55, 65, dev=True, id=2),
        ev("cudaLaunchKernel", 110, 111, id=3),
        ev("march_bwd_kernel", 120, 180, dev=True, id=3),
        ev("cudaMemsetAsync", 112, 113, id=7),
        ev("Memset (Device)", 180, 185, dev=True, id=7),
        ev("ncclDevKernel_AllReduce_Sum_f32", 175, 195, dev=True, id=4,
           linked=77),
        ev("c10d::allreduce_", 150, 152, id=77),
        ev("cudaMemcpyAsync", -10, -9, id=5),
        ev("Memcpy HtoD", 1, 5, dev=True, id=5),
        ev(metrics.UNIT, 0, 100, dev=True, annotation=True),
        ev("aten::mul", 80, 99, id=9),
    ]


def test_summarize_attributes_by_launch_and_measures_the_window():
    s = metrics.summarize(trace())
    assert s["units"] == 2 and s["entries"] == 6 and s["unattributed"] == 0
    assert s["launches"] == dict(k1=1, k2=1, fold=0, nccl=1, adam=1,
                                 copies=1, rest=1)
    assert s["kind_us"]["k1"] == 30 and s["kind_us"]["k2"] == 60
    assert s["kind_us"]["adam"] == 10 and s["kind_us"]["nccl"] == 20
    assert s["kind_us"]["copies"] == 5 and s["kind_us"]["rest"] == 5
    # busy: 20-65, 120-195; window 0-200
    assert s["busy_us"] == 45 + 75
    assert s["window_us"] == 200
    assert s["device_ops"][0] == ["march_bwd_kernel", 60e-6]
    gaps = dict(s["idle_gaps"])
    # the gap 65-120 is labelled by the host operation running at 92.5
    assert gaps["aten::mul"] == pytest.approx(55e-6)


def test_readers_on_a_summary():
    s = metrics.summarize(trace())
    run = {"ranks": [s, dict(s, busy_us=50)], "host_issue_ms": [1.0, 3.0,
                                                                2.0],
           "work": {"k1": {"ms": 0.015}, "k2": {"ms": 0.006}}}
    read = {n: metrics.reader(n)(run) for n in (
        "k1_roofline.fit", "k2_roofline.fit", "adam_ms.fit", "nccl_ms.fit",
        "idle_pct.fit", "launches.fit", "launches.orbit", "idle_pct.orbit",
        "host_issue_ms.orbit", "k1_roofline.orbit")}
    assert read["k1_roofline.fit"] == pytest.approx(100 * 15 / 60)
    assert read["k2_roofline.fit"] == pytest.approx(100 * 6 / 120)
    assert read["adam_ms.fit"] == pytest.approx(0.005)
    assert read["nccl_ms.fit"] == pytest.approx(0.010)
    assert read["idle_pct.fit"] == pytest.approx(75.0)
    # the two steps' ray setup: one kernel of no kind and one fill
    assert read["launches.fit"] == read["launches.orbit"] == 1
    assert read["idle_pct.orbit"] == read["idle_pct.fit"]
    assert read["host_issue_ms.orbit"] == 2.0
    assert read["k1_roofline.orbit"] == read["k1_roofline.fit"]


def test_readers_find_nothing_in_an_empty_trace():
    empty = metrics.summarize([ev(metrics.UNIT, 0, 10)])
    run = {"ranks": [empty], "work": {}, "host_issue_ms": []}
    for name in ("k1_roofline.fit", "k2_roofline.fit", "adam_ms.fit",
                 "nccl_ms.fit", "idle_pct.fit", "launches.fit",
                 "launches.orbit",
                 "idle_pct.orbit", "host_issue_ms.orbit",
                 "k1_roofline.orbit"):
        assert metrics.reader(name)(run) is None, name


def test_a_metric_is_read_by_its_own_module_or_its_stem(tmp_path,
                                                        monkeypatch):
    assert metrics.reader_path("idle_pct.orbit") == \
        metrics.reader_path("idle_pct.fit") == \
        metrics.reader_path("idle_pct")
    (tmp_path / "idle_pct.py").write_text("def read(run):\n    return 1\n")
    (tmp_path / "idle_pct.serve.py").write_text(
        "def read(run):\n    return 2\n")
    monkeypatch.setattr(metrics, "HERE", str(tmp_path))
    assert metrics.reader("idle_pct.fit")({}) == 1
    assert metrics.reader("idle_pct.serve")({}) == 2
