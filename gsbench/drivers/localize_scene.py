"""Closed-loop localization at scene scale: the ``localize`` driver's
traffic, window and capture, held against the plain refinement that blends
through ``reference/walk.py`` (each block of tiles walked only until its
pixels saturate), so that checking 50-iteration queries over millions of
(Gaussian, tile) pairs fits a run. Traffic parameters and the check are
``localize``'s."""

from __future__ import annotations

import numpy as np
import torch

from gsbench import registry
from gsbench.reference import walk

base = registry.driver("localize")
State, Capture = base.State, base.Capture
setup, run_window, work, flops = (base.setup, base.run_window, base.work,
                                  base.flops)


def reference_track(st, idx: int, dtype):
    """The plain refinement of pool query ``idx`` in ``dtype``."""
    cam = st.true_cams[idx]
    c0 = cam.at(torch.tensor(st.inits[idx], dtype=dtype,
                             device=cam.w2c.device))
    img, dep = st.targets[idx]
    dev = cam.w2c.device
    gt = torch.tensor(img, device=dev).to(dtype)
    gtd = None if dep is None else torch.tensor(dep, device=dev).to(dtype)
    return walk.refine(st.map.to(dtype), c0, gt, gtd, base.tracking_cfg(st))


def check(ctx, st, window, control=None) -> dict:
    """Every answer of the sampled queries against the reference. With
    ``control`` (a dtype), the reference computed in that dtype takes the
    program's place."""
    st.gaussians = st.queries = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    worst = {}
    for idx in base.sample(ctx, st):
        ref = base._from_track(reference_track(st, idx, torch.float64))
        answers = [base._from_program(pose, calls)
                   for j, pose, calls in st.done if j == idx]
        if control is not None:
            answers = [base._from_track(reference_track(st, idx, control))]
        for ans in answers:
            for k, v in base.gaps(ans, ref).items():
                v = v if np.isfinite(v) else np.inf
                worst[k] = max(worst.get(k, 0.0), v)
    lim = ctx.limits
    return {k: {"value": v, "limit": lim[k]} for k, v in worst.items()}
