"""What decides ``correct``, driven on the CPU at a tiny size: a sound run
passes; the control (the plain reference in bfloat16 in the program's
place) fails; and the timed path broken underneath in each way the cell
can be broken fails. The harness's look for a card is skipped; everything
else of a run is driven (``run.run_cell`` on the CPU, the program's plain
kernel versions)."""

import pytest
import torch

import gsbench_tiny
from gsbench import faults, run

LOCALIZE = ["7scenes-localize", "cambridge-localize"]
SECONDS = 2.0


def _run(name, control=None):
    cell = gsbench_tiny.cell(name)
    return run.run_cell(cell, gsbench_tiny.SEED, SECONDS, False, "cpu",
                        control=control)


@pytest.mark.parametrize("name", LOCALIZE + ["7scenes-train"])
def test_sound_run_is_correct(name, one_thread):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", LOCALIZE + ["7scenes-train"])
def test_control_is_not_correct(name, one_thread):
    res = _run(name, control=torch.bfloat16)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", LOCALIZE)
@pytest.mark.parametrize("fault", faults.LOCALIZE, ids=lambda f: f.__name__)
def test_broken_localization_is_not_correct(name, fault, monkeypatch,
                                            one_thread):
    fault(monkeypatch.setattr)
    res = _run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.TRAIN, ids=lambda f: f.__name__)
def test_broken_training_is_not_correct(fault, monkeypatch, one_thread):
    fault(monkeypatch.setattr)
    res = _run("7scenes-train")
    assert not res["correct"], res["checks"]
