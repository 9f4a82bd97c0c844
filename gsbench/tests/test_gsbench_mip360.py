"""The two cells of the scene-scale configuration and the Cambridge
training cell, driven on the CPU at a tiny size (``gsbench_tiny``): a sound
run is correct; the control (the plain reference in bfloat16 in the
program's place) is not; nor is a run whose loss reads half the image."""

import pytest
import torch

import gsbench_tiny
from gsbench import faults, run

CELLS = {"mip360-localize": faults.half_the_pixels_localize,
         "cambridge-train": faults.half_the_pixels_train}
SECONDS = 2.0


def _run(name, control=None):
    cell = gsbench_tiny.cell(name)
    return run.run_cell(cell, gsbench_tiny.SEED, SECONDS, False, "cpu",
                        control=control)


@pytest.mark.parametrize("name", list(CELLS))
def test_sound_run_is_correct(name, one_thread):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", list(CELLS))
def test_control_is_not_correct(name, one_thread):
    res = _run(name, control=torch.bfloat16)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", list(CELLS))
def test_half_the_pixels_is_not_correct(name, monkeypatch, one_thread):
    CELLS[name](monkeypatch.setattr)
    res = _run(name)
    assert not res["correct"], res["checks"]
