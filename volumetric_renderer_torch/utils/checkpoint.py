"""Checkpoint / resume for optimization state.

The long-running workloads — TF-fit and grid inversion (BASELINE configs
3-5) — restart from a checkpoint on failure: fail fast, then resume.  A
depth-sharded grid is saved whole, gathered on one rank, and split into
the ranks' rows again on load (``gather`` / ``split``).

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


def _map_params(params: dict, optimizer_state: dict, fns: dict) -> dict:
    """Apply ``fns[name]`` to parameter ``name`` and to every tensor of its
    optimizer state with the parameter's shape (Adam's moments); returns
    the mapped parameters.  ``optimizer_state["state"]`` gets new per-
    parameter dicts (a ``state_dict()`` shares them with the live
    optimizer).  The optimizer's parameter ``i`` is the ``i``-th entry of
    ``params`` (``init_state``)."""
    per_param = optimizer_state["state"]
    for i, (name, p) in enumerate(params.items()):
        if name in fns and i in per_param:
            per_param[i] = {
                key: fns[name](v) if torch.is_tensor(v) and
                v.shape == p.shape else v
                for key, v in per_param[i].items()}
    return {k: fns[k](v) if k in fns else v for k, v in params.items()}


def save_checkpoint(path: str, state, step: Optional[int] = None, *,
                    gather: Optional[dict] = None, write: bool = True) -> str:
    """Atomically write ``state`` (a ``parallel.train.TrainState``) to
    ``path``; ``step`` defaults to ``state.step``.

    ``gather`` maps a parameter name to a function that makes the whole
    tensor from this rank's part (``parallel.depth.gather_rows``); it is
    applied to the parameter and its per-element optimizer state.  When it
    gathers across ranks every rank calls this, and only the one with
    ``write`` set (the rank the parts are gathered on) writes the file."""
    params = {k: v.detach() for k, v in state.params.items()}
    optimizer_state = state.optimizer.state_dict()
    if gather:
        params = _map_params(params, optimizer_state, gather)
    if not write:
        return path
    payload = {
        "params": {k: v.cpu() for k, v in params.items()},
        "optimizer": optimizer_state,
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


def load_checkpoint(path: str, like, *,
                    split: Optional[dict] = None) -> Tuple[object, int]:
    """Load a checkpoint written by :func:`save_checkpoint` into ``like``
    (e.g. a freshly initialised state): its parameters are overwritten in
    place, on their own device, and its optimizer takes the saved state.
    ``split`` maps a parameter name to a function that cuts this rank's
    part from the whole saved tensor (``parallel.depth.split_rows``), for
    the parameter and its per-element optimizer state.  Returns ``(state,
    step)``.  Raises ``ValueError`` when the stored structure does not match
    ``like``'s."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if split:
        ck["params"] = _map_params(ck["params"], ck["optimizer"], split)
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
