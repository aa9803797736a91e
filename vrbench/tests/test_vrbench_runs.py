"""Whole runs of tiny cells: a sound run comes out correct, and the
control and each fault a cell can have come out not correct.

On the CPU the harness's look for a card is skipped and the renderer runs
its kernels' plain versions; the four-rank cell runs four processes over
``gloo``.  The tests marked ``cuda`` run the same tiny cells through the
CUDA kernels and skip without a card::

    python -m pytest vrbench/tests -q -m cuda
"""

from __future__ import annotations

import pytest
import torch

from vrbench.tests.cells import run_copy, tiny_copy


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("vrbench"))


@pytest.mark.parametrize("workload", ["tiny-orbit", "tiny-fit"])
def test_a_sound_run_is_correct(copy, workload):
    res = run_copy(copy, workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", ["tiny-orbit", "tiny-fit"])
def test_a_traced_run_reads_its_trace(copy, workload):
    res = run_copy(copy, workload, trace=1)
    assert res["correct"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("workload,hook", [
    ("tiny-orbit", "control"), ("tiny-fit", "control"),
    ("tiny-orbit", "altered"), ("tiny-fit", "half_batch"),
    ("tiny-fit", "unchanged")])
def test_the_control_and_every_fault_are_not_correct(copy, workload, hook):
    res = run_copy(copy, workload, hooks=("cpu", hook))
    assert res["correct"] is False and res["failed"] > 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("hook,correct", [(None, True),
                                          ("no_exchange", False),
                                          ("half_batch", False)])
def test_four_ranks(copy, hook, correct):
    hooks = ("cpu",) + ((hook,) if hook else ())
    res = run_copy(copy, "tiny-fit4", hooks=hooks)
    assert res["correct"] is correct
    assert res["device"]["count"] == 4


def test_four_ranks_refuse_jax_loaded_in_rank_1(copy):
    proc = run_copy(copy, "tiny-fit4", hooks=("cpu", "jax_on_rank_1"),
                    check=False)
    assert proc.returncode not in (0, None)
    assert proc.stdout.strip() == ""
    assert "jax loaded in rank 1" in proc.stderr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny-orbit", "tiny-fit"])
def test_tiny_cells_on_the_card(cuda, copy, workload):
    res = run_copy(copy, workload, hooks=())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    res = run_copy(copy, workload, hooks=("control",))
    assert res["correct"] is False
