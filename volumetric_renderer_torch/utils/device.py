"""Host-to-device plumbing that never makes the host wait for the card.

PyTorch copies a tensor from pageable host memory to a CUDA device as a
copy and a ``cudaStreamSynchronize``: the host waits until the card has
drained all the work queued before, and the card then idles until the
host has queued the next operation.  A frame or a training step that did
that for each small constant would wait many times per call.  So:

* :func:`constant` makes a constant tensor once per device and hands back
  that same tensor after (it must not be changed in place);
* :func:`per_device` makes any per-device value once, on a device's first
  use;
* :func:`to_device` moves host tensors to a CUDA device in one
  asynchronous copy from pinned memory and leaves a tensor that is already
  there as it is.

Nothing is pinned for a CPU target: a CPU tensor needs no copy there.
"""

from __future__ import annotations

import functools

import torch


def device_key(device) -> torch.device:
    """``device`` with its index, so that one card has one cache key."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def outside_inference(make):
    """``make()`` run in normal mode and without grad: a cached tensor made
    inside ``torch.inference_mode()`` could not be saved for a later
    backward."""
    with torch.inference_mode(False), torch.no_grad():
        return make()


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device):
    return outside_inference(
        lambda: torch.tensor(values, dtype=dtype, device=device))


def constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device``, made on the
    first call for these values and device (which may wait for the card)
    and the same tensor on every later one.  ``values`` is a number or a
    (nested) tuple of numbers."""
    return _constant(values, dtype, device_key(device))


def per_device(make):
    """A function ``on(device)`` that returns ``make(device)``, called on
    the first use of each device and cached for the later ones."""
    made = {}

    def on(device):
        device = device_key(device)
        if device not in made:
            made[device] = outside_inference(lambda: make(device))
        return made[device]

    return on


def to_device(tensors, device) -> list:
    """``tensors`` on ``device``: those already there as they are, host
    tensors bound for a CUDA device packed into one pinned buffer per
    dtype and copied in one ``non_blocking`` copy each (PyTorch's caching
    host allocator keeps a buffer until its copy has run), any other by
    ``Tensor.to``."""
    device = device_key(device)
    out = list(tensors)
    groups = {}
    for i, t in enumerate(out):
        if t.device == device:
            continue
        if device.type == "cuda" and t.device.type == "cpu":
            groups.setdefault(t.dtype, []).append(i)
        else:
            out[i] = t.to(device)
    for idx in groups.values():
        flat = torch.cat([out[i].reshape(-1) for i in idx]).pin_memory()
        flat = flat.to(device, non_blocking=True)
        start = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[start:start + n].view(out[i].shape)
            start += n
    return out


def as_device(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)`` through
    :func:`to_device`: a tensor already on ``device`` is not copied (only
    cast, on the device, where ``dtype`` asks), and host data reaches a
    CUDA device in one asynchronous copy."""
    x = x if torch.is_tensor(x) else torch.as_tensor(x, dtype=dtype)
    if dtype is not None:
        x = x.to(dtype)
    return to_device([x], device)[0]
