#!/usr/bin/env python3
"""Times the ray-march kernels and the training steps of one checkout of
the port on one CUDA card, so that two checkouts, or two builds of a
kernel, can be compared in turns on the same card.

    PYTHONPATH=<checkout> python volumetric_renderer_torch/apps/time_kernels.py \\
        [--what k1|k2|all] [--cases A,B,..] [--iters N] [--label NAME]

Run it by path: ``volumetric_renderer_torch`` is then imported from the
checkout that ``PYTHONPATH`` names, and its kernels are built from that
checkout's ``csrc/`` into its own ``build/``.  Prints one JSON line with
the card's name and power limit and these times in ms, each the median of
``--iters`` runs after one warm-up (CUDA events):

* ``k2_config3_ms``: K2 on BASELINE config 3's frame (256^3 sphere,
  1920x1080, 512 steps of 1.8/512, early termination off, 256-texel TF
  with alpha ``linspace(0, 1)**2``, camera yaw 30 pitch 20);
* ``k2_config4_view_ms``: K2 on one view of config 4 (the same grid, TF and
  steps, 256x256, yaw 0 pitch 20, the first view of ``apps.optimize``'s
  ring);
* ``k2_512_chunks_ms``: K2 on each of 4 depth chunks along z of a 512^3
  sphere, 1920x1080, 512 steps (``k2_512_chunks_sum_ms`` their sum), and
  ``k2_512_whole_ms``: K2 on the whole 512^3 grid at the same view;

and with ``--what all`` also ``k1_config3_ms``, ``k1_config4_view_ms``,
``frame_ref_ms`` (the reference frame,
early termination on, through ``render(method="kernel")``: ray setup and
K1), ``step_config3_ms`` (``render(method="kernel")`` and the backward of a
pixel loss at config 3), each with its ``_host_waits`` beside it (the
synchronizing CUDA runtime calls a call makes, :func:`host_waits`; the
camera is a host one),
``app_step_config4_ms`` (the mean step wall time of ``apps.optimize
invert`` at config 4: 32 views at 256x256, 5 steps after a 1-step run),
``app_step_config5_depth_ms`` (the same for config 5 under ``--parallel
depth`` in one process: the 512^3 sphere, 2 views at 1920x1080, 3 steps
after a 1-step run) and ``app_step_config5_pixels_ms`` (config 5 under
``--parallel pixels``, 8 views, in one process);

and for the config-4 step itself (``parallel.train.make_train_step``, as
``apps.optimize invert`` runs it: 32 views of the 256^3 sphere at 256x256,
512 steps, tile-cyclic, Adam, the loss read on the host every step):
``step_config4_ms`` (CUDA events around a step), ``step_config4_device_ms``
and ``step_config4_device_ops`` (per step, the device time and the count
of the ``torch.profiler``'s device entries, kernels, copies and fills, but
host-device copies), ``step_config4_launches`` (K1 and K2 launches and K1
texture copies per step), ``step_config4_host_top`` and
``step_config4_device_top`` (the 10 host and device entries of most self
time per step, ``[name, ms, calls]``), ``step_config4_host_waits``
(synchronizing CUDA runtime calls per step, the loss read included,
:func:`host_waits`), and ``k1_config4_stacked_ms``,
``k2_config4_stacked_ms`` (K1 and K2 on the 32 views' tile-cyclic rays
stacked along rows, built view by view, the step's single launch of each);
and the same ``step_config5_depth_*`` fields for the depth-sharded step
(``parallel.train.make_depth_train_step``) in one process: 8 views of the
512^3 sphere at 1920x1080 on the optimize app's two opposing yaw arcs
(-40..40 and 140..220 degrees, pitch 20), 512 steps, the grid split along
their dominant axis, Adam, the loss read on the host every step.  Each
of the two steps also gives its ``_fixed_*`` fields: the same, with the
grid put back before every step to the one the trajectory had reached
(:func:`fixed_grid_fields`), so that the step's time and its device time
come from steps that do the same work.

``--what app5`` gives ``app_step_config5_depth_8views_ms`` and
``app_step_config5_pixels_8views_ms``: the mean step wall time of
``apps.optimize invert`` at config 5 with 8 views under ``--parallel
depth`` and ``--parallel pixels`` (4 steps after a 1-step run), in the
process group ``torchrun`` starts, one process per card::

    PYTHONPATH=<checkout> torchrun --standalone --nproc_per_node 4 \
        volumetric_renderer_torch/apps/time_kernels.py --what app5

and then, for each parallel mode, a ``torch.profiler`` trace of a third
run of :data:`TRACE_STEPS` steps on every rank, split per step by
:func:`step_breakdown` (its wall time, device time by kind, idle share,
launches).  Rank 0 prints one line per rank, ``{"trace_rank": r, ...}``
(gathered with ``all_gather_object``), before the line of times.

The optimize app's own ``train_s`` alone would not do: its first step in
a process builds the kernels (nvcc) and fills K1's texture, so a timed
run must follow a warm-up run in the same process; this mode runs both
parallel modes after their warm-ups in one process group (one start of
the processes, not four) and prints one line with every card's name and
power limit, as the other modes do.

``--what k1`` times K1 alone on these cases, each twice: ``k1_<case>_
event_ms``, CUDA events around the whole ``march_forward`` call (the
wrapper's host work included), and ``k1_<case>_device_ms``, the median of
the ``march_fwd_kernel`` entries of a ``torch.profiler`` run (the kernel
alone; ``None`` where the profiler saw no such entry):

* ``ref_frame``: the reference frame (256^3 sphere, 1920x1080, 512 steps,
  early termination on, yaw 30 pitch 20);
* ``ref_frame_own_whole``: the same with the whole-volume ownership range
  ``own=(0, 0, 256, 256)`` (a zero halo row appended);
* ``ref_frame_inner``: the same in the slicing window [0.01, 0.99]^3, where
  every corner a sample reads lies inside the grid;
* ``config3``: early termination off; ``config4_view``: 256x256, yaw 0,
  early termination off;
* ``c512_whole``: the 512^3 sphere at 1920x1080, early termination off;
* ``c512_fold``: the same in 4 depth chunks along z, as the depth fold
  marches them: each call cuts the 4 chunks (``parallel.depth.chunk_of``)
  and marches each; its device time is the 4 kernels' sum per call, and
  ``k1_c512_fold_copy_device_ms`` the device time per call of the copies
  into K1's texture (the profiler's ``Memcpy`` entries but host-device
  ones; their names in ``k1_c512_fold_copy_names``);
* ``ref_frame_refill``, ``config4_view_refill`` and ``c512_whole_refill``:
  those cases with the grid alternating between two equal tensors, so that
  K1 copies the grid into its texture before every launch (the copy's
  cost is the difference to the case itself);

and the ``ptxas`` lines of K1's build (registers, spills).  ``--cases``
times only the named ones.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import subprocess
from unittest import mock

import numpy as np
import torch

from volumetric_renderer_torch.utils.metrics import PhaseTimers, time_calls


def cuda_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` over ``iters`` runs after one warm-up."""
    return statistics.median(time_calls(fn, iters, "cuda"))


def device_entries(events) -> list:
    """The device activity among a ``torch.profiler`` run's ``events``:
    kernels, copies and fills.  Not the spans that a ``record_function``
    range (``Optimizer.step#...``, ``nccl:...``, a user's) also leaves on
    the device's timeline: those are user annotations, named as on the
    host, and counting them would count their kernels twice."""
    from torch.autograd import DeviceType
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host]


def device_ms(fn, iters: int, kernel: str):
    """Device times of the entries (:func:`device_entries`) whose name
    holds ``kernel`` in a ``torch.profiler`` run of ``fn`` ``iters`` times
    after one warm-up: ``(median ms of an entry, number of entries, ms per
    call of fn, the entries' names)``; ``(None, 0, None, [])`` where the
    profiler saw none.  ``kernel="Memcpy"`` takes no host-device copy."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = []
    for _ in range(3):     # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in device_entries(prof.events())
                if kernel in e.name
                and not ("HtoD" in e.name or "DtoH" in e.name)]
        us = [e.time_range.elapsed_us() for e in hits]
        if us:
            break
    if not us:
        return None, 0, None, []
    return (statistics.median(us) / 1e3, len(us), sum(us) / 1e3 / iters,
            sorted({e.name for e in hits}))


#: The CUDA runtime calls that make the host wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def host_waits(fn, calls: int = 3):
    """Synchronizing CUDA runtime calls (:data:`SYNC_CALLS`) per call of
    ``fn``, in a ``torch.profiler`` run of ``calls`` calls after one
    warm-up: those made inside ``fn``, not the profiler's own.  ``None``
    where the profiler saw no runtime call inside ``fn`` at all (a
    profiler run now and then records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                with record_function("host_waits_call"):
                    fn()
            torch.cuda.synchronize()
        events = prof.events()
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "host_waits_call"
                 and e.device_type == DeviceType.CPU]
        inside = [e.name for e in events if e.name.startswith("cuda")
                  and any(a <= e.time_range.start <= b for a, b in spans)]
        if inside:
            return sum(name in SYNC_CALLS for name in inside) / calls
    return None


def step_fields(prefix: str, one_step, iters: int) -> dict:
    """``<prefix>_ms`` (CUDA events around ``one_step``), ``_device_ms``
    and ``_device_ops`` (per step, the device time and the count of the
    ``torch.profiler``'s device entries but host-device copies),
    ``_launches`` (K1 and K2 launches and K1 texture copies per step),
    ``_host_top`` (the 10 host entries of most self time per step,
    ``[name, ms, calls]``), ``_device_top`` (the same for the device
    time) and ``_host_waits`` (synchronizing runtime calls per step,
    :func:`host_waits`) of a training step ``one_step``."""
    from torch.profiler import ProfilerActivity, profile

    from volumetric_renderer_torch.kernels.march import (
        march_backward, march_forward,
    )

    res = {f"{prefix}_ms": cuda_ms(one_step, iters)}
    _, n, per_step, _ = device_ms(one_step, iters, "")
    res[f"{prefix}_device_ms"] = per_step
    res[f"{prefix}_device_ops"] = n / iters
    torch.cuda.synchronize()
    march_forward.launches = march_backward.launches = 0
    march_forward.texture_fills = 0
    one_step()
    res[f"{prefix}_launches"] = {
        "march_fwd": march_forward.launches,
        "march_bwd": march_backward.launches,
        "texture_fills": march_forward.texture_fills}
    # where the host's time goes: the operations and CUDA runtime calls of
    # most self time on the host (a wait for the device shows as the self
    # time of the runtime call that waits), ms and calls per step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            one_step()
    entries = prof.key_averages()
    top = sorted(entries, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:10]
    res[f"{prefix}_host_top"] = [
        [e.key, e.self_cpu_time_total / 3e3, e.count / 3] for e in top]
    # and the device's: the entries of most device time of their own
    top = sorted(entries, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    res[f"{prefix}_device_top"] = [
        [e.key, e.self_device_time_total / 3e3, e.count / 3] for e in top
        if e.self_device_time_total > 0]
    res[f"{prefix}_host_waits"] = host_waits(one_step)
    return res


def fixed_grid_fields(prefix: str, state: list, one_step, iters: int):
    """:func:`step_fields` of ``one_step`` with the grid put back before
    each step (``<prefix>_fixed_*``): on the training trajectory K2's time
    changes with the grid, so the timed steps and the profiled ones of
    :func:`step_fields` do different work; here every step does the same
    (that of the grid the trajectory has reached), and the copy back, one
    device-to-device copy of the grid, is timed with the step."""
    params = state[0].params
    snapshot = params["vol"].detach().clone()

    def fixed_step():
        with torch.no_grad():
            params["vol"].copy_(snapshot)
        one_step()

    return step_fields(f"{prefix}_fixed", fixed_step, iters)


def config5_depth_step(tf, iters: int) -> dict:
    """The ``step_config5_depth_*`` times of the module docstring: the
    depth-sharded train step in one process, with the ``tf`` as truth."""
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.parallel.depth import (
        dominant_axis, make_depth_sharded_renderer, split_rows,
    )
    from volumetric_renderer_torch.parallel.train import (
        init_depth_state, make_depth_train_step,
    )
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.utils.config import RenderSettings

    dev = tf.device
    vol = Volume.synthetic_sphere(512).as_torch(dev)
    settings = RenderSettings(height=1080, width=1920, step_size=1.8 / 512,
                              early_termination=False)
    yaws = np.concatenate([np.linspace(-40.0, 40.0, 4),
                           np.linspace(140.0, 220.0, 4)])
    cams = [OrbitCamera.from_angles(float(a), 20.0) for a in yaws]
    axis = dominant_axis(cams)
    fixed = dict(vol=split_rows(vol, axis), tf=tf, dmin=vol.min(),
                 dmax=vol.max(), smin=torch.zeros(3, device=dev),
                 smax=torch.ones(3, device=dev))
    render_fn = make_depth_sharded_renderer(None, settings,
                                            vol_shape=vol.shape, axis=axis)
    with torch.no_grad():
        targets = torch.stack([
            render_fn(fixed["vol"], tf, c, fixed["dmin"], fixed["dmax"],
                      fixed["smin"], fixed["smax"]) for c in cams])
    step = make_depth_train_step(settings, optimize_vol=True,
                                 optimize_tf=False, vol_shape=vol.shape,
                                 axis=axis)
    state = [init_depth_state({"vol": torch.full_like(vol, 0.3)},
                              lambda p: torch.optim.Adam(p, lr=5e-2),
                              axis=axis)]
    del vol

    def one_step():
        state[0], loss = step(state[0], fixed, cams, targets)
        float(loss)

    res = step_fields("step_config5_depth", one_step, iters)
    res.update(fixed_grid_fields("step_config5_depth", state, one_step,
                                 iters))
    res["step_config5_depth_views"] = len(cams)
    res["step_config5_depth_axis"] = axis
    return res


#: Steps of the optimize app in each traced run of ``--what app5``.
TRACE_STEPS = 3
#: Device entries by kind, matched in order on the lowered entry name; an
#: entry that matches none is Adam's where it starts inside the device span
#: of an ``Optimizer.step`` range, else "rest".
DEVICE_KINDS = (("k1", "march_fwd_kernel"), ("k2", "march_bwd_kernel"),
                ("nccl", "nccl"), ("copies", "memcpy"), ("copies", "memset"))


class TracedTimers(PhaseTimers):
    """:class:`PhaseTimers` whose phases are also spans of a
    ``torch.profiler`` trace (``record_function``), so that a trace of the
    optimize app shows each ``train_step``."""

    @contextlib.contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(name), super().phase(name):
            yield


def step_breakdown(events, span: str = "train_step") -> dict:
    """Per step of a ``torch.profiler`` trace (the CPU spans named
    ``span``; a step ends with a read of its loss, so its device work lies
    inside its span): the mean wall time ``wall_ms``, the device time of
    each kind of :data:`DEVICE_KINDS` plus ``adam`` and ``rest`` (sums of
    :func:`device_entries`, which overlap where two streams run at once),
    the time some entry runs (``device_busy_ms``) and the idle share ``1 -
    busy/wall``, the K1 and K2 launches, the NCCL entries and the 8
    largest "rest" entries by name, and the 8 host operations whose
    kernels take most of the "rest" and Adam (``rest_by_op_ms``), ms per
    step."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == span and e.device_type == DeviceType.CPU)
    entries = device_entries(events)
    counted = {id(e) for e in entries}
    adam_spans = [(e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA and id(e) not in counted
                  and e.name.startswith("Optimizer.step")]
    kinds = dict.fromkeys(("k1", "k2", "nccl", "adam", "copies", "rest"),
                          0.0)
    launches = {"k1": 0, "k2": 0}
    by_name = {"nccl": collections.Counter(), "rest": collections.Counter()}
    busy = []
    for e in entries:
        a, b = e.time_range.start, e.time_range.end
        inside = [(s, t) for s, t in spans if s <= a <= t]
        if not inside:
            continue
        busy.append((a, min(b, inside[0][1])))
        name = e.name.lower()
        kind = next((k for k, key in DEVICE_KINDS if key in name), None)
        if kind is None:
            kind = ("adam" if any(s <= a <= t for s, t in adam_spans)
                    else "rest")
        kinds[kind] += (b - a) / 1e3
        if kind in launches:
            launches[kind] += 1
        if kind in by_name:
            by_name[kind][e.name] += (b - a) / 1e3
    # the "rest" by the operation that launched it (the profiler's own
    # attribution of kernels to host operations): its outermost operation
    # in the step, or the backward node it runs in
    by_op = collections.Counter()
    for e in events:
        if (e.device_type != DeviceType.CPU or not getattr(e, "kernels", None)
                or not any(s <= e.time_range.start <= t for s, t in spans)):
            continue
        top, op = e, e.cpu_parent
        while (op is not None and op.name != span
               and not top.name.startswith("autograd::engine::")):
            top, op = op, op.cpu_parent
        for k in e.kernels:
            if not any(key in k.name.lower() for _, key in DEVICE_KINDS):
                by_op[top.name] += k.duration / 1e3
    busy_ms, end = 0.0, float("-inf")
    for a, b in sorted(busy):              # the union of the entries
        busy_ms += max(0.0, b - max(a, end)) / 1e3
        end = max(end, b)
    n = max(1, len(spans))
    wall_ms = sum(t - s for s, t in spans) / 1e3 / n
    return dict(
        steps=len(spans), wall_ms=wall_ms,
        device_ms={k: v / n for k, v in kinds.items()},
        device_busy_ms=busy_ms / n,
        idle_share=1.0 - busy_ms / n / wall_ms if spans else None,
        launches={k: v / n for k, v in launches.items()},
        nccl_ms={k: v / n for k, v in by_name["nccl"].most_common()},
        rest_top_ms={k: v / n for k, v in by_name["rest"].most_common(8)},
        rest_by_op_ms={k: v / n for k, v in by_op.most_common(8)})


def traced_app_steps(argv: list) -> dict:
    """:func:`step_breakdown` of ``apps.optimize.main(argv)`` traced by
    ``torch.profiler`` (CPU and, where present, CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    from volumetric_renderer_torch.apps import optimize
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with mock.patch.object(optimize, "PhaseTimers", TracedTimers), \
            profile(activities=activities) as prof:
        optimize.main(argv)
    return step_breakdown(prof.events())


def config5_apps(res: dict, smi: str) -> dict:
    """``--what app5``: the ``app_step_config5_{depth,pixels}_8views_ms``
    times of the module docstring in the process group that ``torchrun``
    starts (one process per card), or in one process without it; rank 0
    prints them."""
    import torch.distributed as dist

    from volumetric_renderer_torch.apps import optimize
    from volumetric_renderer_torch.parallel.distributed import (
        init_distributed,
    )

    init_distributed()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    res.update(world=world, nvidia_smi_all=smi)
    trace = dict(trace_rank=rank, world=world,
                 gpu=torch.cuda.get_device_name(), nvidia_smi_all=smi,
                 steps_traced=TRACE_STEPS)
    for par in ("depth", "pixels"):
        c5 = ["invert", "--grid", "512", "--size", "1920x1080",
              "--march-steps", "512", "--views", "8", "--device", "cuda",
              "--parallel", par]
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stderr(null):
            optimize.main(c5 + ["--steps-opt", "1"])
            run = optimize.main(c5 + ["--steps-opt", "4"])
            trace[par] = traced_app_steps(
                c5 + ["--steps-opt", str(TRACE_STEPS)])
        res[f"app_step_config5_{par}_8views_ms"] = \
            1e3 * run["train_s"] / len(run["losses"])
        res[f"app_config5_{par}_8views_losses"] = run["losses"]
    traces = [trace]
    if dist.is_initialized():
        traces = [None] * world
        dist.all_gather_object(traces, trace)
    if rank == 0:
        for line in traces:
            print(json.dumps(line), flush=True)
        print(json.dumps(res), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return res


def config4_step(vol, tf, iters: int) -> dict:
    """The ``step_config4_*`` and ``k*_config4_stacked_ms`` times of the
    module docstring, on the 256^3 grid ``vol`` and the TF ``tf``."""
    from volumetric_renderer_torch.core.marcher import (
        frame_inputs, prepare_rays,
    )
    from volumetric_renderer_torch.kernels.march import (
        march_backward, march_forward,
    )
    from volumetric_renderer_torch.parallel.mesh import make_layout
    from volumetric_renderer_torch.parallel.train import (
        init_state, make_train_step,
    )
    from volumetric_renderer_torch.render.api import render
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.utils.config import RenderSettings

    dev = vol.device
    settings = RenderSettings(height=256, width=256, step_size=1.8 / 512,
                              early_termination=False)
    cams = [OrbitCamera.from_angles(float(a), 20.0)
            for a in np.linspace(0.0, 360.0, 32, endpoint=False)]
    with torch.no_grad():
        targets = torch.stack([render(vol, tf, c, settings, method="kernel")
                               for c in cams])
    fixed = dict(vol=vol, tf=tf, dmin=vol.min(), dmax=vol.max(),
                 smin=torch.zeros(3, device=dev),
                 smax=torch.ones(3, device=dev))
    step = make_train_step(settings, optimize_vol=True, optimize_tf=False,
                           row_layout="tile-cyclic")
    state = [init_state({"vol": torch.full_like(vol, 0.3)},
                        lambda p: torch.optim.Adam(p, lr=5e-2))]

    def one_step():
        state[0], loss = step(state[0], fixed, cams, targets)
        float(loss)

    res = step_fields("step_config4", one_step, iters)
    res.update(fixed_grid_fields("step_config4", state, one_step, iters))

    # the step's rays, view by view: each view's tile-cyclic block, stacked
    gh, gw, pack, _, _ = make_layout("tile-cyclic", 256, 256, 1)
    origins, dirs = [], []
    for c in cams:
        origin, d, dmin, dmax, smin, smax = frame_inputs(vol, c, settings)
        dirs.append(pack(d))
        origins.append(origin.expand(gh, 1, 3))
    dirs = torch.cat(dirs).contiguous()
    pos0, hit, inv_w = prepare_rays(torch.cat(origins), dirs, dmin, dmax)
    kargs = (vol, tf, pos0, dirs, hit, dmin, inv_w, smin, smax)
    march = dict(num_steps=512, step_size=1.8 / 512, early_termination=False,
                 termination_eps=1.0 / 255.0)
    g = np.random.default_rng(7).normal(size=tuple(hit.shape) + (4,))
    g = torch.as_tensor(g.astype(np.float32), device=dev)
    out = march_forward(*kargs, **march)
    res["k1_config4_stacked_ms"] = cuda_ms(
        lambda: march_forward(*kargs, **march), iters)
    res["k2_config4_stacked_ms"] = cuda_ms(
        lambda: march_backward(*kargs, out, g, **march), iters)
    res["config4_stacked_shape"] = list(hit.shape)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--what", choices=["k1", "k2", "all", "app5"],
                    default="all")
    ap.add_argument("--cases", default="",
                    help="with --what k1: a comma-separated subset of the "
                    "cases (default: all)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")

    import volumetric_renderer_torch as pkg
    from volumetric_renderer_torch.apps import optimize
    from volumetric_renderer_torch.core.marcher import (
        frame_inputs, prepare_rays,
    )
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.kernels import _build
    from volumetric_renderer_torch.kernels.march import (
        march_backward, march_forward,
    )
    from volumetric_renderer_torch.parallel.depth import chunk_of
    from volumetric_renderer_torch.render.api import render
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.transfer.gradient import Gradient
    from volumetric_renderer_torch.utils.config import RenderSettings

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout
    res = dict(label=args.label, package=os.path.dirname(pkg.__file__),
               gpu=torch.cuda.get_device_name(0),
               nvidia_smi=smi.splitlines()[0], iters=args.iters)
    if args.what == "app5":
        return config5_apps(res, smi)
    ramp = Gradient.grayscale_ramp().discretize(256)
    ramp[:, 3] = np.linspace(0.0, 1.0, 256, dtype=np.float32) ** 2
    tf = torch.as_tensor(ramp, device=dev)

    def case(vol, yaw, h, w, et=False, slicing=(None, None)):
        settings = RenderSettings(height=h, width=w, step_size=1.8 / 512,
                                  early_termination=et)
        cam = OrbitCamera.from_angles(yaw, 20.0)
        origin, dirs, dmin, dmax, smin, smax = frame_inputs(
            vol, cam, settings, None, None, *slicing)
        pos0, hit, inv_w = prepare_rays(origin, dirs, dmin, dmax)
        march = dict(num_steps=512, step_size=1.8 / 512,
                     early_termination=et, termination_eps=1.0 / 255.0)
        g = np.random.default_rng(7).normal(size=(h, w, 4))
        g = torch.as_tensor(g.astype(np.float32), device=dev)
        return ((vol, tf, pos0, dirs, hit, dmin, inv_w, smin, smax), march,
                g, cam, settings)

    vol = Volume.synthetic_sphere(256).as_torch(dev)
    if args.what == "k1":
        res["ptxas"] = [ln.strip() for ln in
                        _build.build("march_fwd").log.splitlines()
                        if "Used" in ln or "spill" in ln]
        vol5 = Volume.synthetic_sphere(512).as_torch(dev)
        inner = ((0.01,) * 3, (0.99,) * 3)
        runs = [("ref_frame", case(vol, 30.0, 1080, 1920, et=True), None),
                ("ref_frame_own_whole", case(vol, 30.0, 1080, 1920, et=True),
                 (0, 0, 256, 256)),
                ("ref_frame_inner", case(vol, 30.0, 1080, 1920, et=True,
                                         slicing=inner), None),
                ("config3", case(vol, 30.0, 1080, 1920), None),
                ("config4_view", case(vol, 0.0, 256, 256), None),
                ("c512_whole", case(vol5, 30.0, 1080, 1920), None)]
        runs.append(("c512_fold", runs[-1][1], "fold"))
        runs += [(key + "_refill", case_, "refill") for key, case_, own in runs
                 if key in ("ref_frame", "config4_view", "c512_whole")]
        if args.cases:
            runs = [r for r in runs if r[0] in args.cases.split(",")]
        for key, (kargs, march, *_), own in runs:
            grids = [kargs[0]]
            if own == "refill":       # two equal grids, taken in turns
                grids, own = [kargs[0], kargs[0].clone()], None
            elif own is not None and own != "fold":   # the whole range
                grids = [chunk_of(vol, 0, 256, 0)]

            def k1(kargs=kargs, march=march, own=own, grids=grids):
                if own == "fold":
                    for c in range(4):
                        march_forward(chunk_of(kargs[0], c, 128, 0),
                                      *kargs[1:], **march,
                                      own=(0, c * 128, 128, 512))
                    return None
                grids.reverse()
                return march_forward(grids[0], *kargs[1:], **march, own=own)

            res[f"k1_{key}_event_ms"] = cuda_ms(k1, args.iters)
            dev_ms, n, per_call, _ = device_ms(k1, args.iters,
                                               "march_fwd_kernel")
            res[f"k1_{key}_device_ms"] = per_call if own == "fold" else dev_ms
            res[f"k1_{key}_device_entries"] = n
            if own == "fold":
                _, _, copy_ms, names = device_ms(k1, args.iters, "Memcpy")
                res["k1_c512_fold_copy_device_ms"] = copy_ms
                res["k1_c512_fold_copy_names"] = names
        print(json.dumps(res), flush=True)
        return res

    for key, yaw, h, w in (("config3", 30.0, 1080, 1920),
                           ("config4_view", 0.0, 256, 256)):
        kargs, march, g, cam, settings = case(vol, yaw, h, w)
        out = march_forward(*kargs, **march)
        res[f"k2_{key}_ms"] = cuda_ms(
            lambda: march_backward(*kargs, out, g, **march), args.iters)
        if args.what == "all":
            res[f"k1_{key}_ms"] = cuda_ms(
                lambda: march_forward(*kargs, **march), args.iters)
        if args.what == "all" and key == "config3":
            def kernel_step():
                leaves = [vol.detach().requires_grad_(True),
                          tf.detach().requires_grad_(True)]
                img = render(leaves[0], leaves[1], cam, settings,
                             method="kernel")
                (img * g).sum().backward()

            res["step_config3_ms"] = cuda_ms(kernel_step, args.iters)
            res["step_config3_host_waits"] = host_waits(kernel_step)
            et_on = RenderSettings(height=h, width=w, step_size=1.8 / 512)

            def frame():
                return render(vol, tf, cam, et_on, method="kernel")

            res["frame_ref_ms"] = cuda_ms(frame, args.iters)
            res["frame_ref_host_waits"] = host_waits(frame)
        del kargs, out, g

    if args.what in ("k2", "all"):
        vol5 = Volume.synthetic_sphere(512).as_torch(dev)
        kargs, march, g, _, _ = case(vol5, 30.0, 1080, 1920)
        body = 512 // 4
        chunk_ms = []
        for c in range(4):
            cargs = (chunk_of(vol5, c, body, 0),) + kargs[1:]
            own = (0, c * body, body, 512)
            out = march_forward(*cargs, **march, own=own)
            chunk_ms.append(cuda_ms(lambda: march_backward(
                *cargs, out, g, **march, own=own), args.iters))
            del cargs, out
        res["k2_512_chunks_ms"] = chunk_ms
        res["k2_512_chunks_sum_ms"] = sum(chunk_ms)
        out = march_forward(*kargs, **march)
        res["k2_512_whole_ms"] = cuda_ms(
            lambda: march_backward(*kargs, out, g, **march), args.iters)
        del vol5, kargs, g, out

    if args.what == "all":
        res.update(config4_step(vol, tf, args.iters))
        res.update(config5_depth_step(tf, args.iters))
        inv = ["invert", "--grid", "256", "--size", "256x256",
               "--march-steps", "512", "--views", "32", "--device", "cuda"]
        with open(os.devnull, "w") as null, contextlib.redirect_stderr(null):
            optimize.main(inv + ["--steps-opt", "1"])
            run = optimize.main(inv + ["--steps-opt", "5"])
        res["app_step_config4_ms"] = 1e3 * run["train_s"] / len(run["losses"])
        c5 = ["invert", "--grid", "512", "--size", "1920x1080",
              "--march-steps", "512", "--views", "2", "--device", "cuda",
              "--parallel", "depth"]
        with open(os.devnull, "w") as null, contextlib.redirect_stderr(null):
            optimize.main(c5 + ["--steps-opt", "1"])
            run = optimize.main(c5 + ["--steps-opt", "3"])
        res["app_step_config5_depth_ms"] = \
            1e3 * run["train_s"] / len(run["losses"])
        c5[c5.index("--views") + 1], c5[-1] = "8", "pixels"
        with open(os.devnull, "w") as null, contextlib.redirect_stderr(null):
            optimize.main(c5 + ["--steps-opt", "1"])
            run = optimize.main(c5 + ["--steps-opt", "3"])
        res["app_step_config5_pixels_ms"] = \
            1e3 * run["train_s"] / len(run["losses"])

    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
