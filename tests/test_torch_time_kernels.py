"""``apps/time_kernels.py``, the timer of the kernels alone: its filter of
a ``torch.profiler`` run's device entries, on made-up events, and its
command line on the CPU: two modes, ``k1`` and ``k2``, each of which
refuses to run without a CUDA card before it builds anything."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from volumetric_renderer_torch.apps.time_kernels import device_entries, main
from volumetric_renderer_torch.kernels import _build


def event(name, start, end, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_device_entries_leave_out_the_spans_of_ranges():
    cuda = DeviceType.CUDA
    kept = event("elementwise_kernel<mul>", 1, 2, cuda)
    got = device_entries([event("MarchFunctionBackward", 0, 9),
                          event("MarchFunctionBackward", 0, 9, cuda),
                          event("user_span", 0, 9, cuda, annotation=True),
                          kept])
    assert got == [kept]


@pytest.mark.parametrize("what", ["all", "app5"])
def test_main_takes_no_step_or_app_mode(what):
    """The step and app timings are the benchmark's fit cells' now: their
    modes are argparse's usage error."""
    with pytest.raises(SystemExit) as raised:
        main(["--what", what])
    assert raised.value.code == 2


@pytest.mark.parametrize("what", ["k1", "k2"])
def test_main_needs_a_cuda_card_before_it_builds(what, monkeypatch):
    builds = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "build", lambda *a, **k: builds.append(a))
    with pytest.raises(SystemExit) as raised:
        main(["--what", what])
    assert raised.value.code == "time_kernels: needs a CUDA card"
    assert builds == []
