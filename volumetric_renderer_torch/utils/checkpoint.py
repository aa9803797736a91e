"""Checkpoint / resume for optimization state.

The long-running workloads — TF-fit and grid inversion (BASELINE configs
3-4) — restart from a checkpoint on failure: fail fast, then resume.

Format: one ``torch.save`` file per step holding ``{"params": {name:
tensor}, "optimizer": optimizer.state_dict(), "step": int}``, written
atomically (a temporary file in the same directory, then ``os.replace``)
so a killed run never leaves a torn checkpoint.  Tensors are saved on the
CPU and loaded with ``weights_only=True`` onto the device of the state they
are restored into, so a checkpoint written on the card resumes on the CPU
and back.  The round trip is exact.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import torch


def _structure(params: dict, optimizer_state: dict) -> tuple:
    """What a checkpoint must share with the state it is loaded into:
    parameter names, shapes and dtypes, and the optimizer's parameter
    groups and per-parameter state keys."""
    groups = tuple(tuple(g["params"]) for g in optimizer_state["param_groups"])
    state = tuple(sorted((k, tuple(sorted(v))) for k, v in
                         optimizer_state["state"].items()))
    return (tuple((k, tuple(v.shape), str(v.dtype))
                  for k, v in sorted(params.items())), groups, state)


def save_checkpoint(path: str, state, step: Optional[int] = None) -> str:
    """Atomically write ``state`` (a ``parallel.train.TrainState``) to
    ``path``; ``step`` defaults to ``state.step``."""
    payload = {
        "params": {k: v.detach().cpu() for k, v in state.params.items()},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step if step is None else step),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, like) -> Tuple[object, int]:
    """Load a checkpoint written by :func:`save_checkpoint` into ``like``
    (e.g. a freshly initialised state): its parameters are overwritten in
    place, on their own device, and its optimizer takes the saved state.
    Returns ``(state, step)``.  Raises ``ValueError`` when the stored
    structure does not match ``like``'s."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    have = _structure(ck["params"], ck["optimizer"])
    want = _structure(like.params, like.optimizer.state_dict())
    # a fresh optimizer has no per-parameter state yet: compare only what
    # it has
    if have[:2] != want[:2] or (want[2] and have[2] != want[2]):
        raise ValueError(f"checkpoint structure mismatch: {path} was written "
                         "for a different state structure")
    with torch.no_grad():
        for k, v in like.params.items():
            v.copy_(ck["params"][k])
    like.optimizer.load_state_dict(ck["optimizer"])
    step = ck["step"]
    return like._replace(step=step), step


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Most recent ``{prefix}{step}.pt`` in ``directory`` (or None)."""
    suffix = ".pt"
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(suffix):
            try:
                s = int(name[len(prefix):-len(suffix)])
            except ValueError:
                continue
            if s > best_step:
                best, best_step = os.path.join(directory, name), s
    return best
