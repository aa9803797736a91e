"""Run one cell of the benchmark and print its result as the last line.

    python3 -m vrbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``workloads/<name>.json``) names
its configuration, its traffic kind, the traffic's parameters and the
cards it needs.  A run sets up (the inputs from the seed, the renderer's
kernels from the checkout's build cache, a warm-up of the cell's own
shapes), measures for ``--seconds``, checks what the timed path produced
against the plain reference (``checks``), and prints one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; the numbers compared come last,
each beside its limit, there and on standard error.

A cell on several cards starts one process a card itself (ranks 1 and up;
this process is rank 0 and prints the result), joined by NCCL over a
local TCP rendezvous.  NCCL's shared-memory transport is switched off
(``NCCL_SHM_DISABLE=1``): the cards talk over NVLink, and the run keeps
no file outside its checkout and the caller's home and temporary
directories.

Without as many CUDA cards as the cell asks for, with JAX or the JAX
package loaded in any rank once the window has closed, or with a rank
process that exits with a code other than 0, the run prints no result
and exits with a code other than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from dataclasses import dataclass  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: Top-level modules that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "volumetric_renderer_tpu")
#: Seconds the process group waits for a rank before it gives up.
GROUP_TIMEOUT_S = 180


@dataclass
class Cell:
    """What a traffic module gets: the cell's name, its file (``spec``),
    its configuration, the run's arguments, and this process's rank,
    world, device and process group (None: the default group, or a world
    of one)."""
    name: str
    spec: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    rank: int = 0
    world: int = 1
    device: object = None
    group: object = None

    @property
    def params(self) -> dict:
        return self.spec["params"]


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` of the benchmark's folder."""
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def for_cell(entries, name: str) -> list:
    """The metric entries that ``name`` reports: those without a
    ``workloads`` key and those that list it."""
    return [e for e in entries if name in e.get("workloads", [name])]


def require_cuda(chips: int):
    """The device type of a run on ``chips`` cards; exits without a
    result where the machine has fewer CUDA cards."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.exit(f"vrbench: the cell needs {chips} CUDA card(s), found {n}; "
                 "no result")
    return "cuda"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the ranks it starts
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(argv, world: int, port: int) -> list:
    """Ranks 1 .. world - 1, each a process running this module."""
    return [subprocess.Popen([sys.executable, "-m", "vrbench.run", *argv,
                              "--rank", str(r), "--port", str(port)],
                             cwd=ROOT, stdout=subprocess.DEVNULL)
            for r in range(1, world)]


def watch(procs) -> None:
    """End this run, and every rank, once a rank has failed: the others
    would wait for it in a collective."""
    def loop():
        while True:
            for p in procs:
                if p.poll() not in (None, 0):
                    print(f"vrbench: rank process {p.pid} exited with "
                          f"{p.returncode}; no result", file=sys.stderr,
                          flush=True)
                    stop(procs)
                    os._exit(1)
            time.sleep(0.5)
    threading.Thread(target=loop, daemon=True).start()


def stop(procs, timeout: float = 0.0) -> None:
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        if p.poll() is None:
            p.kill()
            p.wait()


def join_group(kind: str, rank: int, world: int, port: int):
    """This rank's device; on several ranks, the default process group
    joined."""
    import datetime

    import torch
    import torch.distributed as dist
    device = torch.device(kind, rank) if kind == "cuda" else \
        torch.device(kind)
    if kind == "cuda":
        torch.cuda.set_device(device)
    if world > 1:
        dist.init_process_group(
            "nccl" if kind == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return device


def card(device) -> dict:
    """The card's name and power limit (``nvidia-smi``), for the record."""
    import torch
    if device.type != "cuda":
        return {"name": "cpu"}
    info = {"name": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        info["nvidia_smi"] = out
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"unavailable: {e}"
    return info


def result(cell: Cell, out: dict, setup_s: float, bench: dict) -> dict:
    """The result line of rank 0 from the traffic's ``out``."""
    from vrbench.metrics import reader
    values = dict(out["metrics"], setup_s=setup_s)
    info = card(cell.device)
    metrics = {}
    if cell.trace:
        for e in for_cell(bench["per_layer"], cell.name):
            value = reader(e["name"])(out["trace"])
            if value is not None:
                metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    else:
        for e in for_cell(bench["end_to_end"], cell.name):
            metrics[e["name"]] = {"value": values[e["name"]],
                                  "unit": e["unit"]}
    device = {"platform": "gpu" if cell.device.type == "cuda"
              else cell.device.type,
              "kind": info["name"], "count": cell.world,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": out["correct"], "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics, "device": device}
    if cell.trace:
        ranks = out["trace"]["ranks"]
        device["busy_s"] = sum(r["busy_us"] for r in ranks) / 1e6 / len(ranks)
        device["window_s"] = sum(r["window_us"] for r in ranks) / 1e6 / len(
            ranks)
        res["breakdown"] = {"device_ops": ranks[0]["device_ops"],
                            "idle_gaps": ranks[0]["idle_gaps"]}
        res["unattributed_entries"] = [r["unattributed"] for r in ranks]
    res["card"] = info
    res["setup_s"] = setup_s
    res["checks"] = out["checks"]
    return res


def main(argv=None, t0: float = T0) -> int:
    """Run the cell; ``t0`` is the process's start on the host clock."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    # tests, and the readings of the check's limits, break or redirect the
    # run here, in every rank (vrbench/tests/faults.py)
    for hook in filter(None, os.environ.get("VRBENCH_PATCH", "").split(",")):
        module, fn = hook.split(":")
        getattr(importlib.import_module(module), fn)()
    bench = benchmark()
    spec = load("workloads", args.workload)
    config = load("configs", spec["config"])
    world = int(spec["chips"])
    kind = require_cuda(world)
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")
    # any kernel cache a library keeps goes inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    procs = []
    if world > 1 and args.rank == 0:
        args.port = free_port()
        procs = start_ranks(argv, world, args.port)
        watch(procs)
    try:
        device = join_group(kind, args.rank, world, args.port)
        cell = Cell(args.workload, spec, config, args.seed, args.seconds,
                    bool(args.trace), args.rank, world, device)
        traffic = importlib.import_module(f"vrbench.traffic.{spec['traffic']}")
        out = traffic.run(cell)
        from vrbench import session
        found = session.gather(cell, forbidden_modules())
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        stop(procs, timeout=120)
    if args.rank != 0:
        return 0
    # rank 0 judges for every rank: what each had loaded once the window
    # closed, and how each rank process ended
    refused = [f"{', '.join(names)} loaded in rank {r}"
               for r, names in enumerate(found) if names]
    refused += [f"rank process {p.pid} exited with {p.returncode}"
                for p in procs if p.returncode != 0]
    if refused:
        print(f"vrbench: {'; '.join(refused)}; no result", file=sys.stderr,
              flush=True)
        return 3
    res = result(cell, out, out["window_start"] - t0, bench)
    from vrbench import checks
    checks.report(res["checks"])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    # run as the importable module, so that a test's hook patches what
    # runs here
    from vrbench import run as _run
    sys.exit(_run.main(t0=T0))
