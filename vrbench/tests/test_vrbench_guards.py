"""Guards of the benchmark: what it imports, what it does without a card
or with JAX loaded, that BENCHMARK.json keeps to its contract, and that a
cell, a configuration and a metric are added as new files alone."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

from vrbench import metrics
from vrbench.tests.cells import ROOT, add_orbit_metrics, run_copy, tiny_copy

BENCH = os.path.join(ROOT, "vrbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path) -> set:
    """Top-level names of the modules ``path`` imports, and the ``vrbench``
    modules it imports in full."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in _modules():
        tops = {n.split(".")[0] for n in _imports(path)}
        bad = tops & {"jax", "jaxlib", "flax", "volumetric_renderer_tpu"}
        assert not bad, (path, bad)


def _closure(module: str) -> set:
    """The ``vrbench`` modules ``module`` reaches, and the top-level names
    of everything they import."""
    seen, tops, todo = set(), set(), [module]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = os.path.join(ROOT, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(ROOT, *mod.split("."), "__init__.py")
        if not os.path.exists(path):
            continue
        for name in _imports(path):
            tops.add(name.split(".")[0])
            if name.startswith("vrbench"):
                todo.append(name)
    return tops


@pytest.mark.parametrize("module", ["vrbench.reference.march",
                                    "vrbench.reference.camera",
                                    "vrbench.reference.adam", "vrbench.work",
                                    "vrbench.inputs", "vrbench.checks",
                                    "vrbench.metrics"])
def test_the_yardstick_imports_nothing_of_the_renderer(module):
    assert "volumetric_renderer_torch" not in _closure(module)


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "vrbench.run", "--workload", "fit-32x256",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_a_run_with_jax_loaded_prints_no_result(tmp_path):
    d = tiny_copy(tmp_path)
    proc = run_copy(d, "tiny-orbit", hooks=("cpu", "jax_loaded"),
                    check=False)
    assert proc.returncode not in (0, None)
    assert proc.stdout.strip() == ""
    assert "jax" in proc.stderr


def test_benchmark_json_keeps_to_its_contract():
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["vrbench"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("vrbench/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == \
            c["name"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        spec = json.load(open(os.path.join(BENCH, "workloads",
                                           w["name"] + ".json")))
        assert (spec["config"], spec["traffic"], spec["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".py"))
        assert len(w["why"]) <= 200 and spec["limits"]
        mine = [m for m in b["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in b["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer and all(m["moves"] in {x["name"] for x in mine}
                             for m in layer)
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and m["moves"] in e2e
        assert os.path.exists(metrics.reader_path(m["name"]))
    assert len(json.dumps(b)) < 64 * 1024


def _digest(d) -> dict:
    out = {}
    for base, _, files in os.walk(os.path.join(d, "vrbench")):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                out[os.path.relpath(p, d)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_a_cell_config_and_metric_are_new_files_and_entries(tmp_path):
    d = tiny_copy(tmp_path, cells=False)
    before = _digest(d)
    config = json.load(open(os.path.join(d, "vrbench/configs/head256.json")))
    config.update(name="throwaway")
    config["volume"]["n"], config["march"]["num_steps"] = 12, 16
    json.dump(config, open(os.path.join(d, "vrbench/configs/throwaway.json"),
                           "w"))
    cell = json.load(open(os.path.join(d,
                                       "vrbench/workloads/orbit-1080p.json")))
    cell["config"] = "throwaway"
    cell["params"].update(width=16, height=8, warmup_frames=1,
                          check_within=3, checked_frames=1, traced_frames=2)
    json.dump(cell, open(os.path.join(d, "vrbench/workloads/throwaway.json"),
                         "w"))
    with open(os.path.join(d, "vrbench/metrics/frames.throwaway.py"),
              "w") as f:
        f.write("def read(run):\n    return run['ranks'][0]['units']\n")
    b = json.load(open(os.path.join(d, "BENCHMARK.json")))
    b["configs"].append({"name": "throwaway", "source": "a test",
                         "file": "vrbench/configs/throwaway.json",
                         "reduced": ["n"], "why": "a test"})
    b["workloads"].append({"name": "throwaway", "config": "throwaway",
                           "traffic": "orbit", "chips": 1, "why": "a test"})
    add_orbit_metrics(b, ["throwaway"])
    b["per_layer"].append({"name": "frames.throwaway", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "rays_per_s",
                           "workloads": ["throwaway"]})
    json.dump(b, open(os.path.join(d, "BENCHMARK.json"), "w"))
    added = set(_digest(d)) - set(before)
    assert {k: v for k, v in _digest(d).items() if k in before} == before
    assert added == {"vrbench/configs/throwaway.json",
                     "vrbench/workloads/throwaway.json",
                     "vrbench/metrics/frames.throwaway.py"}
    res = run_copy(d, "throwaway", trace=1)
    assert res["metrics"]["frames.throwaway"]["value"] == 2
    res = run_copy(d, "throwaway", trace=0)
    assert set(res["metrics"]) == {"rays_per_s", "frame_p95_ms", "setup_s"}
