"""Tiny cells on the CPU for the tests: a copy of the benchmark in a
temporary directory, with a 16^3 configuration and tiny orbit and fit
cells that keep the real cells' limits, run through the harness."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = {"tiny-orbit": ("orbit-1080p", dict(width=24, height=16,
                                           warmup_frames=1, check_within=4,
                                           checked_frames=2,
                                           traced_frames=2), 1),
        "tiny-fit": ("fit-32x256", dict(views=4, width=16, height=16,
                                        steps_per_fit=4, warmup_steps=1), 1),
        "tiny-fit4": ("fit-8x1080p-4chip", dict(views=2, width=32, height=32,
                                                steps_per_fit=3,
                                                warmup_steps=1), 4)}


#: The orbit's metrics, as a cell of the orbit kind would enter them in
#: BENCHMARK.json (no orbit cell is there: PERF.md, section 7).
ORBIT_METRICS = {
    "end_to_end": [
        {"name": "rays_per_s", "unit": "rays/s", "better": "higher",
         "bound": 0.25, "source": "host_clock"},
        {"name": "frame_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock"}],
    "per_layer": [
        {"name": n, "unit": u, "better": "lower", "source": src,
         "layer": layer, "moves": "rays_per_s"} for n, u, src, layer in (
            ("host_issue_ms.orbit", "ms", "host_clock",
             "API and ray setup on the host"),
            ("launches.orbit", "count", "device_trace", "ray setup"),
            ("k1_roofline.orbit", "%", "device_trace", "kernel K1"),
            ("idle_pct.orbit", "%", "device_trace", "device"))]}


def add_orbit_metrics(bench: dict, cells) -> None:
    """Enter the orbit's metrics for ``cells`` in ``bench``."""
    for kind, entries in ORBIT_METRICS.items():
        names = {m["name"]: m for m in bench[kind]}
        for e in entries:
            if e["name"] not in names:
                names[e["name"]] = dict(e, workloads=[])
                bench[kind].append(names[e["name"]])
            names[e["name"]]["workloads"] += list(cells)


def _load(d, rel):
    with open(os.path.join(d, rel)) as f:
        return json.load(f)


def _save(d, rel, obj):
    with open(os.path.join(d, rel), "w") as f:
        json.dump(obj, f)


def tiny_copy(tmp_path, cells: bool = True) -> str:
    """The benchmark copied into ``tmp_path``; with ``cells``, the tiny
    cells added as new files and entries."""
    d = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "vrbench"), os.path.join(d, "vrbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), d)
    if not cells:
        return d
    config = _load(d, "vrbench/configs/head256.json")
    config.update(name="tiny")
    config["volume"]["n"], config["march"]["num_steps"] = 16, 24
    _save(d, "vrbench/configs/tiny.json", config)
    b = _load(d, "BENCHMARK.json")
    for name, (real, params, chips) in TINY.items():
        spec = _load(d, f"vrbench/workloads/{real}.json")
        spec.update(config="tiny", chips=chips)
        spec["params"].update(params)
        _save(d, f"vrbench/workloads/{name}.json", spec)
        b["workloads"].append({"name": name, "config": "tiny",
                               "traffic": spec["traffic"], "chips": chips,
                               "why": "a test"})
        for m in b["end_to_end"] + b["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    add_orbit_metrics(b, ["tiny-orbit"])
    _save(d, "BENCHMARK.json", b)
    return d


def run_copy(d, workload: str, seed: int = 2718281829, seconds: float = 1,
             trace: int = 0, hooks=("cpu",), check: bool = True):
    """Run ``workload`` in the copy ``d`` on the CPU through the hooks of
    ``vrbench.tests.faults``: the parsed result line, or with
    ``check=False`` the finished process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([d, ROOT]),
               OMP_NUM_THREADS="1", VRBENCH_PATCH=",".join(
                   f"vrbench.tests.faults:{h}" for h in hooks))
    proc = subprocess.run(
        [sys.executable, "-m", "vrbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=d, env=env, capture_output=True, text=True,
        timeout=600)
    if not check:
        return proc
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
