"""The program's spans and counters as a traced run reads them
(``vrbench/metrics/spans.py``, the readers of ``layer_trace.PER_LAYER``,
``vrbench/layer_trace.py``): attribution to the innermost span of a
launch on its own thread, on synthetic events; the readers with nothing
to read; and a tiny traced run through ``layer_trace.install`` on the
CPU (gloo between ranks), and on the card (``-m cuda``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from vrbench import layer_trace, metrics
from vrbench.metrics import spans
from vrbench.tests.cells import ROOT, tiny_copy
from vrbench.tests.test_vrbench_metrics import trace

NEW = [e["name"] for e in layer_trace.PER_LAYER]
MAIN, BACKWARD = 1, 2


def ev(name, start, end, dev=False, id=0, thread=MAIN):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), id=id,
        linked_correlation_id=0, is_user_annotation=False, thread=thread)


def step_trace():
    """One step (0-100 us) on the main thread: ``vr.train_step`` holds
    ``vr.ray_setup`` (a kernel launched at 2, and K1 in ``vr.k1`` nested in
    another ``vr.ray_setup`` that starts with it, at 11), ``vr.loss`` (a
    kernel at 31), ``vr.backward`` (a kernel at 41; on autograd's device
    thread, K2 launched at 45 inside ``vr.k2`` and a kernel at 52 outside
    it, which the backward holds on the main thread) and ``vr.optimizer``
    (Adam's kernel at 71 in ``Optimizer.step``); a copy launched at 95 in
    the step but in no span below it.  Device entries run back to back
    from 10."""
    host = [
        ev(metrics.UNIT, 0, 100), ev("vr.train_step", 1, 99),
        ev("vr.ray_setup", 2, 9), ev("vr.ray_setup", 10, 20),
        ev("vr.k1", 10, 13), ev("vr.loss", 30, 35),
        ev("vr.backward", 40, 60), ev("vr.k2", 44, 50, thread=BACKWARD),
        ev("vr.optimizer", 70, 80), ev("Optimizer.step#Adam.step", 70, 79)]
    launches = [(2, "elementwise_kernel", 4), (11, "march_fwd_kernel<false>",
                                                20),
                (31, "reduce_kernel", 3), (41, "elementwise_kernel", 2),
                (45, "march_bwd_kernel<true, false>", 40),
                (52, "mul_kernel", 5), (71, "multi_tensor_apply_kernel", 6),
                (95, "Memcpy DtoD", 1)]
    events, t = list(host), 10
    for i, (at, name, us) in enumerate(launches, start=1):
        thread = BACKWARD if at in (45, 52) else MAIN
        events += [ev("cudaLaunchKernel", at, at + 0.5, id=i, thread=thread),
                   ev(name, t, t + us, dev=True, id=i)]
        t += us
    return events


def test_an_entry_belongs_to_the_innermost_span_on_its_launching_thread():
    s = spans.summarize(step_trace())
    assert s["span_us"] == {"vr.ray_setup": 4, "vr.k1": 20, "vr.loss": 3,
                            "vr.backward": 7, "vr.k2": 40,
                            "vr.optimizer": 6, "vr.train_step": 1}
    assert s["kind_spans"]["k2"] == {"vr.k2": 1}
    assert s["kind_spans"]["rest"]["vr.backward"] == 2
    assert s["kind_spans"]["k1"] == {"vr.k1": 1}
    assert s["kind_spans"]["adam"] == {"vr.optimizer": 1}
    assert s["span_cover"] == pytest.approx(80 / 81)
    run = {"ranks": [dict(metrics.summarize(step_trace()), **s)]}
    assert metrics.reader("ray_setup_ms.fit")(run) == pytest.approx(0.004)
    assert metrics.reader("loss_ms.fit")(run) == pytest.approx(0.003)
    assert metrics.reader("backward_rest_ms.fit")(run) == pytest.approx(
        0.007)


def test_idle_gaps_are_labelled_by_the_span_on_the_main_thread():
    """Entries at 10-20 and 50-60 of a step 0-100: the gaps 0-10 (in
    ``vr.ray_setup`` at 5), 20-50 (``vr.loss`` at 35) and 60-100 (no span
    at 80)."""
    events = [ev(metrics.UNIT, 0, 100), ev("vr.ray_setup", 2, 8),
              ev("vr.loss", 30, 40), ev("vr.k2", 79, 81, thread=BACKWARD),
              ev("cudaLaunchKernel", 3, 4, id=1), ev("k", 10, 20, True, 1),
              ev("cudaLaunchKernel", 31, 32, id=2), ev("k", 50, 60, True, 2)]
    got = dict(spans.summarize(events)["idle_gaps_by_span"])
    assert got == pytest.approx({"vr.ray_setup": 10e-6, "vr.loss": 30e-6,
                                 spans.OUTSIDE: 40e-6})


def test_a_trace_without_spans_keeps_every_summary_and_reads_nothing():
    """The harness's synthetic trace, with no ``vr.*`` span: ``summarize``
    gives its own keys as before (``test_vrbench_metrics``), every entry
    is outside the program and no new metric reads a value."""
    before = metrics.summarize(trace())
    s = spans.summarize(trace())
    assert set(s["span_us"]) == {spans.OUTSIDE} and s["span_cover"] == 0
    assert metrics.summarize(trace()) == before
    run = {"ranks": [dict(before, **s)], "work": {}}
    for name in NEW:
        assert metrics.reader(name)(run) is None, name


def counters(sampled=10, lane_steps=40, nccl_bytes=0, k1=True):
    k = {"sampled": sampled, "lane_steps": lane_steps, "voxel_atomics": 6e6,
         "tf_flushes": 2e6}
    return {"k1": dict(k) if k1 else None, "k2": dict(k), "steps": 2,
            "nccl_bytes": nccl_bytes}


def test_counter_readers_sum_the_ranks_and_find_nothing_without_counts():
    rank = metrics.summarize(trace())      # 2 units, NCCL 20 us
    two = {"ranks": [dict(rank, counters=counters(nccl_bytes=8e6))] * 2}
    assert metrics.reader("k2_atomics.fit")(two) == 6.0
    assert metrics.reader("k2_flushes.fit")(two) == 2.0
    assert metrics.reader("k2_lane_pct.fit")(two) == 25.0
    assert metrics.reader("k1_lane_pct.fit")(two) == 25.0
    # 4 MB a step, 2 * (2 - 1) / 2 of it, over 10 us a step
    assert metrics.reader("nccl_busbw_gbps.fit")(two) == pytest.approx(
        4e6 / 10e-6 / 1e9)
    # one card; the CPU (no counted launch); a program without counters
    one = {"ranks": [dict(rank, counters=counters(nccl_bytes=8e6))]}
    cpu = {"ranks": [dict(rank, counters=counters(k1=False))] * 2}
    none = {"ranks": [dict(rank, counters=None)] * 2}
    assert metrics.reader("nccl_busbw_gbps.fit")(one) is None
    assert metrics.reader("k1_lane_pct.fit")(cpu) is None
    for name in NEW[3:]:
        assert metrics.reader(name)(none) is None, name


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """The tiny cells, with the metrics of ``layer_trace.PER_LAYER``
    entered for them as for their real cells."""
    d = tiny_copy(tmp_path_factory.mktemp("vrbench_spans"))
    tiny = {"fit-32x256": "tiny-fit", "fit-8x1080p-4chip": "tiny-fit4"}
    path = os.path.join(d, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"] += [
        dict(e, workloads=[tiny[c] for c in e["workloads"]])
        for e in layer_trace.PER_LAYER]
    with open(path, "w") as f:
        json.dump(bench, f)
    return d


def run_traced(d, workload: str, hooks=("vrbench.tests.faults:cpu",)):
    """``workload`` traced in the copy ``d`` through ``layer_trace``; the
    parsed result line."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([d, ROOT]),
               OMP_NUM_THREADS="1", VRBENCH_PATCH=",".join(
                   [*hooks, "vrbench.layer_trace:install"]))
    proc = subprocess.run(
        [sys.executable, "-m", "vrbench.run", "--workload", workload,
         "--seed", "3141592653", "--seconds", "1", "--trace", "1"], cwd=d,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,world", [("tiny-fit", 1),
                                            ("tiny-fit4", 4)])
def test_a_tiny_traced_fit_reads_the_programs_spans_and_counters(
        copy, workload, world):
    """On the CPU: the run stays correct, the counted fit counts the bytes
    each rank hands the all-reduce (the 16^3 grid's gradient and the loss
    a step, on four ranks) and no kernel counts (the plain versions);
    nothing runs on a device, so no span metric reads a value."""
    res = run_traced(copy, workload)
    assert res["correct"] and list(res)[-1] == "checks"
    assert len(res["idle_gaps_by_span"]) == world
    layers = res["layers"]
    assert len(layers["counters"]) == world
    for c in layers["counters"]:
        assert c["k1"] is None and c["steps"] > 0
        assert c["nccl_bytes"] == (c["steps"] * 4 * (16 ** 3 + 1)
                                   if world > 1 else 0)
    assert layers["frozen_samples_per_step"] > 0
    assert not set(NEW) & set(res["metrics"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
def test_a_tiny_traced_fit_reads_the_spans_and_counters_on_the_card(
        cuda, copy):
    """On the card the seven metrics of a one-card fit are read, nearly
    all of the step's device time lies under a span below the step, K1,
    K2 and Adam lie in their own spans, and K2 samples what the frozen
    count needs."""
    res = run_traced(copy, "tiny-fit", hooks=())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(NEW[:-1]) <= set(res["metrics"])
    layers = res["layers"]
    assert layers["span_cover"][0] > 0.99
    kinds = layers["kind_spans"][0]
    assert set(kinds["k1"]) == {"vr.k1"} and set(kinds["k2"]) == {"vr.k2"}
    assert set(kinds["adam"]) == {"vr.optimizer"}
    assert layers["k2_sampled_per_step"] == pytest.approx(
        layers["frozen_samples_per_step"], rel=1e-3)
