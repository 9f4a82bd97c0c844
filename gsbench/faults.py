"""Faults planted in the program's timed path, for showing that each makes
``correct`` false: in the CPU tests (``tests/test_gsbench_correct.py``) and
on the card (``python3 -m gsbench.calibrate --fault <name>``).

Each fault takes ``patch(obj, attr, value)``, which replaces an attribute
and undoes it later (pytest's ``monkeypatch.setattr`` or ``Patches``).
The program looks every patched function up at call time.
"""

from __future__ import annotations

import torch


class Patches:
    def __init__(self):
        self._undo = []

    def __call__(self, obj, attr, value):
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def undo(self):
        for obj, attr, old in reversed(self._undo):
            setattr(obj, attr, old)
        self._undo.clear()


def pose_unchanged(patch):
    """Each refinement returns the pose it was given."""
    from gs_localization_torch.pipelines import localize

    orig = localize.refine_poses_batch

    def fault(gaussians, cameras, *a, **k):
        res = orig(gaussians, cameras, *a, **k)
        return res._replace(w2c=torch.stack([c.w2c for c in cameras]))

    patch(localize, "refine_poses_batch", fault)


def half_the_pixels_localize(patch):
    """The tracking loss is the mean over the top half of the image."""
    from gs_localization_torch.loc import refine

    orig = refine.tracking_loss

    def fault(color, depth, alpha, ab, gt, mask, cfg, gt_depth=None):
        h = color.shape[0] // 2
        return orig(color[:h], depth[:h], alpha[:h], ab, gt[:h], mask[:h],
                    cfg, gt_depth=None if gt_depth is None else gt_depth[:h])

    patch(refine, "tracking_loss", fault)


def answer_altered_localize(patch):
    """Each returned pose moved by 1 mm along x."""
    from gs_localization_torch.pipelines import localize

    orig = localize.localize_queries

    def fault(*a, **k):
        res, metrics = orig(*a, **k)
        for pose in res.values():
            pose[0, 3] += 1e-3
        return res, metrics

    patch(localize, "localize_queries", fault)


def state_unchanged(patch):
    """Each training step returns the state it was given."""
    from gs_localization_torch.pipelines import train_map

    orig = train_map.train_step

    def fault(state, *a, **k):
        _, aux = orig(state, *a, **k)
        return state, aux

    patch(train_map, "train_step", fault)


def half_the_pixels_train(patch):
    """The training loss is the mean over the top half of the image."""
    from gs_localization_torch.mapping import losses

    orig = losses.training_loss

    def fault(image, gt_image, depth=None, gt_depth=None, **k):
        h = image.shape[0] // 2
        return orig(image[:h], gt_image[:h],
                    depth=None if depth is None else depth[:h],
                    gt_depth=None if gt_depth is None else gt_depth[:h], **k)

    patch(losses, "training_loss", fault)


def answer_altered_train(patch):
    """Each step's new logit opacities shifted by 1e-3."""
    from gs_localization_torch.pipelines import train_map

    orig = train_map.train_step

    def fault(*a, **k):
        state, aux = orig(*a, **k)
        g = state.gaussians
        return state.replace(gaussians=g.replace(
            opacity=g.opacity + 1e-3)), aux

    patch(train_map, "train_step", fault)


LOCALIZE = (pose_unchanged, half_the_pixels_localize, answer_altered_localize)
TRAIN = (state_unchanged, half_the_pixels_train, answer_altered_train)
