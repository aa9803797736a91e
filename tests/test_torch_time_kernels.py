"""The per-step trace of ``apps/time_kernels.py``: the split of a
``torch.profiler`` trace into steps and kinds of device time, on made-up
events, and the spans it finds in a traced run of the optimize app on the
CPU (no device entries there: every device time is 0)."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from volumetric_renderer_torch.apps.time_kernels import (
    TRACE_STEPS, device_entries, step_breakdown, traced_app_steps,
)


def event(name, start, end, device=DeviceType.CPU, annotation=False,
          parent=None, kernels=()):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation, cpu_parent=parent,
                           kernels=[SimpleNamespace(name=k, duration=us)
                                    for k, us in kernels],
                           time_range=SimpleNamespace(start=start, end=end))


def test_step_breakdown_splits_device_time_by_kind_within_steps():
    """Times in us: two steps of 100 and 300; the device entries of each
    kind inside them, an Adam entry found by the device span of its
    ``Optimizer.step`` range, two entries that overlap (counted once in the
    busy time), the spans that ranges leave on the device (flagged, or
    named as on the host) counted nowhere, and neither are entries outside
    every step; the "rest" goes to its host operation, through the
    program's ``vr.*`` spans."""
    cuda = DeviceType.CUDA
    step = event("train_step", 0, 100)
    # the program's own spans (``vr.*``) between a step and its operations
    inner = event("vr.train_step", 1, 99, parent=step)
    loss = event("vr.loss", 90, 97, parent=inner)
    node = event("autograd::engine::evaluate_function: FoldBackward", 210,
                 290)
    k2 = event("vr.k2", 239, 252, parent=node)
    events = [
        step, inner, loss, k2, event("train_step", 200, 500),
        # the host operations that launched the "rest": one in the step,
        # one inside a backward node, one outside every step
        event("aten::mul", 94, 95, parent=event("aten::where", 93, 96,
                                                parent=loss),
              kernels=[("elementwise_kernel<mul>", 1.0)]),
        event("aten::sum", 249, 250, parent=event("aten::add", 240, 251,
                                                  parent=k2),
              kernels=[("reduce_kernel<sum>", 10.0),
                       ("void march_bwd_kernel<true>", 90.0)]),
        event("aten::fill_", 600, 601, kernels=[("fill", 10.0)]),
        event("Optimizer.step#Adam.step", 80, 84),
        event("nccl:all_gather", 49, 50),
        event("train_step", 10, 96, cuda, annotation=True),
        event("Optimizer.step#Adam.step", 85, 89, cuda, annotation=True),
        event("nccl:all_gather", 50, 60, cuda),         # named as on the host
        event("void (anonymous namespace)::march_fwd_kernel(float)", 10, 20,
              cuda),
        event("void (anonymous namespace)::march_bwd_kernel<true>(float)",
              20, 50, cuda),
        event("ncclDevKernel_AllGather_RING_LL(x)", 50, 60, cuda),
        event("Memcpy DtoD (Device -> Device)", 60, 62, cuda),
        event("multi_tensor_apply_kernel<Adam>", 85, 88, cuda),
        event("elementwise_kernel<mul>", 95, 96, cuda),
        event("void (anonymous namespace)::march_bwd_kernel<true>(float)",
              210, 300, cuda),
        event("reduce_kernel<sum>", 250, 260, cuda),
        event("ncclDevKernel_AllReduce_Sum_f32(x)", 300, 320, cuda),
        event("void (anonymous namespace)::march_fwd_kernel(float)", 120,
              150, cuda),                               # between the steps
        event("Memset (Device)", 600, 610, cuda),       # after them
    ]
    got = step_breakdown(events)
    assert got["steps"] == 2 and got["wall_ms"] == pytest.approx(0.2)
    want = dict(k1=0.005, k2=0.06, fold=0.0, nccl=0.015, adam=0.0015,
                copies=0.001, rest=0.0055)
    for k, v in want.items():
        assert got["device_ms"][k] == pytest.approx(v), k
    # step 1 busy 10..62, 85..88, 95..96 = 56 us; step 2 210..320 = 110 us
    assert got["device_busy_ms"] == pytest.approx(0.083)
    assert got["idle_share"] == pytest.approx(1.0 - 0.083 / 0.2)
    assert got["launches"] == {"k1": 0.5, "k2": 1.0, "fold": 0.0}
    assert list(got["nccl_ms"]) == ["ncclDevKernel_AllReduce_Sum_f32(x)",
                                    "ncclDevKernel_AllGather_RING_LL(x)"]
    assert got["rest_top_ms"] == pytest.approx(
        {"reduce_kernel<sum>": 0.005, "elementwise_kernel<mul>": 0.0005})
    assert got["rest_by_op_ms"] == pytest.approx(
        {"autograd::engine::evaluate_function: FoldBackward": 0.005,
         "aten::where": 0.0005})


def test_step_breakdown_counts_the_fold_kernels_as_their_own_kind():
    """The depth fold's forward and backward kernels (``csrc/fold.cu``) are
    the kind ``fold``, with their launches; they are not in the rest, by
    kernel or by host operation."""
    cuda = DeviceType.CUDA
    step = event("train_step", 0, 100)
    node = event("autograd::engine::evaluate_function: _GatherFoldBackward",
                 60, 90, parent=step)
    events = [
        step,
        event("_GatherFold", 10, 20, parent=step,
              kernels=[("void (anonymous namespace)::fold_fwd_kernel(x)",
                        4.0)]),
        event("aten::empty_like", 61, 62, parent=node,
              kernels=[("void (anonymous namespace)::fold_bwd_kernel(x)",
                        6.0)]),
        event("void (anonymous namespace)::fold_fwd_kernel(float4 const*)",
              20, 24, cuda),
        event("void (anonymous namespace)::fold_bwd_kernel(float4 const*)",
              70, 76, cuda),
        event("elementwise_kernel<mul>", 80, 82, cuda),
    ]
    got = step_breakdown(events)
    assert got["device_ms"]["fold"] == pytest.approx(0.01)
    assert got["device_ms"]["rest"] == pytest.approx(0.002)
    assert got["launches"] == {"k1": 0, "k2": 0, "fold": 2}
    assert got["rest_top_ms"] == pytest.approx(
        {"elementwise_kernel<mul>": 0.002})
    assert got["rest_by_op_ms"] == {}


def test_device_entries_leave_out_the_spans_of_ranges():
    cuda = DeviceType.CUDA
    kept = event("elementwise_kernel<mul>", 1, 2, cuda)
    got = device_entries([event("MarchFunctionBackward", 0, 9),
                          event("MarchFunctionBackward", 0, 9, cuda),
                          event("user_span", 0, 9, cuda, annotation=True),
                          kept])
    assert got == [kept]


@pytest.mark.parametrize("parallel", ["pixels", "depth"])
def test_traced_app_steps_finds_each_train_step_on_cpu(parallel):
    got = traced_app_steps(
        ["invert", "--grid", "8", "--size", "16x16", "--march-steps", "8",
         "--views", "2", "--steps-opt", str(TRACE_STEPS), "--device", "cpu",
         "--parallel", parallel])
    assert got["steps"] == TRACE_STEPS and got["wall_ms"] > 0
    assert got["device_busy_ms"] == 0 and got["idle_share"] == 1.0
    assert set(got["device_ms"].values()) == {0.0}
