"""What every traffic kind does alike: wait for the card, trace a segment,
read the peak of memory, and gather a value from every rank."""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from vrbench import metrics


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def traced(device, out: list):
    """Profile the block (CPU and, on a card, CUDA activity) and append the
    summary of its units (``metrics.summarize``) to ``out``; the block
    ends with the card idle, by its own last wait."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    out.append(metrics.summarize(prof.events()))


def unit():
    """The host span of one frame or step in a traced segment."""
    return torch.profiler.record_function(metrics.UNIT)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def gather(cell, value) -> list:
    """``value`` of every rank, rank 0 first (a world of one: ``[value]``)."""
    if cell.world == 1:
        return [value]
    out = [None] * cell.world
    dist.all_gather_object(out, value)
    return out


def free(device) -> None:
    """Give the card's cached blocks back, after the renderer's state is
    dropped, so that the reference has the room."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
