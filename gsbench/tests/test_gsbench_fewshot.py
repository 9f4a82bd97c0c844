"""What decides ``correct`` in the few-shot training cell, driven on the
CPU at a tiny size (``gsbench_tiny``): a sound run passes; the control (the
plain references in bfloat16 in the program's place) fails; and so do the
training loss taken over half the pixels, the pseudo term taken over half
the pixels and an estimator whose prior is altered. The network keeps its
widths; its input is cut to 64x96 in the program and the configuration
alike, and the pseudo phase opens at step 2 with a pseudo step every 5, so
that a two-second window holds several."""

import torch

import gsbench_tiny
from gsbench import faults, run

SECONDS = 2.0


def _run(monkeypatch, control=None):
    from gs_localization_torch.ops import dpt

    cell = gsbench_tiny.cell("7scenes-train-fewshot")
    cell.config["depth_prior"]["input"] = [64, 96]
    cell.config["schedule"]["start_sample_pseudo"] = 2
    cell.config["fewshot"]["sample_pseudo_interval"] = 5
    monkeypatch.setattr(dpt, "NET_SIZE", (64, 96))
    return run.run_cell(cell, gsbench_tiny.SEED, SECONDS, False, "cpu",
                        control=control)


def test_sound_run_is_correct(monkeypatch, one_thread):
    res = _run(monkeypatch)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for k in ("prior_gap", "pseudo_loss_gap", "pseudo_term_gap",
              "pseudo_grad_gap"):
        assert res["checks"][k]["value"] <= res["checks"][k]["limit"]


def test_control_is_not_correct(monkeypatch, one_thread):
    res = _run(monkeypatch, control=torch.bfloat16)
    assert not res["correct"], res["checks"]
    assert res["checks"]["prior_gap"]["value"] \
        > res["checks"]["prior_gap"]["limit"]


def test_half_the_pixels_is_not_correct(monkeypatch, one_thread):
    faults.half_the_pixels_train(monkeypatch.setattr)
    res = _run(monkeypatch)
    assert not res["correct"], res["checks"]
    assert res["checks"]["pseudo_loss_gap"]["value"] \
        > res["checks"]["pseudo_loss_gap"]["limit"]


def test_altered_prior_is_not_correct(monkeypatch, one_thread):
    from gs_localization_torch.ops import dpt

    orig = dpt.estimate_depth

    def altered(params, image, out_h, out_w):
        d = orig(params, image, out_h, out_w)
        return d + 0.01 * d.abs().max() * torch.linspace(
            0, 1, out_w, dtype=d.dtype)

    monkeypatch.setattr(dpt, "estimate_depth", altered)
    res = _run(monkeypatch)
    assert not res["correct"], res["checks"]
    assert res["checks"]["prior_gap"]["value"] \
        > res["checks"]["prior_gap"]["limit"]


def test_pseudo_term_over_half_the_pixels_is_not_correct(monkeypatch,
                                                         one_thread):
    from gs_localization_torch.mapping import losses

    orig = losses.pearson_depth_loss

    def half(prior, depth):
        h = prior.shape[0] // 2
        return orig(prior[:h], depth[:h])

    monkeypatch.setattr(losses, "pearson_depth_loss", half)
    res = _run(monkeypatch)
    assert not res["correct"], res["checks"]
    assert res["checks"]["pseudo_term_gap"]["value"] \
        > res["checks"]["pseudo_term_gap"]["limit"]
