"""LoGS's Mip-NeRF 360 localization preset on the CPU at a small size.

``presets.mip360_localize()`` (monocular, <= 50 Adam iterations at lr 1e-3,
convergence 1e-4, a rebin every 10) through the port's
``localize_queries`` on the stream layout, against the benchmark's plain
float64 refinement (``gsbench/reference/track.py``), at 99x66 px: a frame
width and height that are not multiples of the 16-pixel tile. Each map
holds 3,000 Gaussians in a box wider than the view, so that, as in a
scene-scale map, most of them lie outside it; those in view are large and
nearly opaque, so that the opacity mask (alpha > 0.99) holds enough pixels
for a steady loss. Each query runs all 50 iterations and 5 rebins on both
sides.

The rebin's records under the profiler (``render/project``, the counter
``stream_slots`` and the live aligned length noted on ``refine/rebin``)
are held to the values of the packs they describe.
"""

import numpy as np
import pytest
import torch

from gs_localization_torch.core.camera import Camera
from gs_localization_torch.pipelines import presets
from gs_localization_torch.pipelines.localize import (QuerySpec,
                                                      localize_queries)
from gs_localization_torch.raster import RasterizerConfig, pose_mode
from gs_localization_torch.utils import profiling
from gsbench import registry, scene
from gsbench.reference import track

SEEDS = (1, 2)
SENSOR = {"width": 99, "height": 66, "fx": 80.0, "fy": 80.0, "cx": 49.5,
          "cy": 33.0}
MAP = {"num_gaussians": 3000, "sh_degree": 1,
       "box": [[-40.0, 40.0], [-24.8, 24.8], [1.5, 25.0]],
       "log_scale": [-1.2, -0.5], "rgb": [0.05, 0.95], "sh_rest_std": 0.05,
       "opacity_logit": [1.5, 4.5]}
# a small stream and chunk: the CPU's plain blend walks whole chunks
RASTER = RasterizerConfig(max_pairs=1 << 14, max_render=1 << 14,
                          pallas_chunk=32)
# float32 against float64 through 50 Adam steps: the gaps read 2.7e-7 to
# 6.5e-7 m, 5.6e-8 to 8.4e-7 rad, relative 8e-8 to 3.5e-7 (first loss)
# and 1.9e-6 to 5.6e-6 (first gradient) on these seeds; the limits leave
# ten times that and more, and a bfloat16 side misses them by orders
POSE_M, POSE_RAD, LOSS, GRAD = 1e-5, 1e-5, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _query(seed: int):
    """The seed's map (float32), true camera, initial pose and target."""
    m = scene.make_map(MAP, seed, "cpu")
    pose = scene.moved_poses(1, 0.1, 0.03, seed, 1)[0]
    tau = scene.init_tangents(1, 0.01, 0.02, seed, 2)[0]
    cam = scene.camera(SENSOR, torch.tensor(pose, dtype=torch.float32))
    init = scene.se3_exp_np(tau) @ pose
    ((color, _),) = scene.render_targets(m, [cam])
    return m, cam, init, color


def _localize(seed: int, lcfg):
    """The port's refinement of the seed's query -> (pose, its capture)."""
    drv = registry.driver("localize")
    m, cam, init, color = _query(seed)
    q = QuerySpec("q", Camera.from_numpy(
        init.astype(np.float32), cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
        cam.height, device="cpu"), color.numpy())
    cap = drv.Capture()
    with cap():
        res, _ = localize_queries(drv._program_map(m), [q], lcfg, RASTER,
                                  log_fn=lambda s: None)
    (call,) = cap.calls
    return res["q"], call


@pytest.fixture(scope="module")
def answers():
    """Per seed: the port's answer and the reference's, each as the
    localize driver's ``gaps`` reads them."""
    drv = registry.driver("localize")
    lcfg = presets.mip360_localize()
    tcfg = drv.tracking_cfg(type("St", (), {"lcfg": lcfg})())
    out = {}
    for seed in SEEDS:
        pose, call = _localize(seed, lcfg)
        m, cam, init, color = _query(seed)
        ref = track.refine(m.to(torch.float64),
                           cam.at(torch.tensor(init)), color.double(), None,
                           tcfg)
        out[seed] = (drv._from_program(pose, [call]), drv._from_track(ref))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_mip360_localize_matches_reference(answers, seed):
    prog, ref = answers[seed]
    assert prog["iters"] == ref["iters"] == 50
    gaps = registry.driver("localize").gaps(prog, ref)
    assert gaps["pose_gap_m"] < POSE_M, gaps
    assert gaps["pose_gap_rad"] < POSE_RAD, gaps
    assert gaps["loss_gap"] < LOSS, gaps
    assert gaps["grad_gap"] < GRAD, gaps


def test_mip360_records_match_the_pack(monkeypatch):
    """Under the profiler, 12 iterations (rebins at 0 and 10): one
    ``render/project`` span an iteration inside its ``refine/render``;
    each rebin's ``stream_slots`` and noted ``kept_al`` are its pack's
    columns and live aligned length."""
    from torch.profiler import ProfilerActivity, profile

    packs = []
    build = pose_mode.build_stream_pair_pack

    def keep(*args, **kwargs):
        packs.append(build(*args, **kwargs))
        return packs[-1]

    monkeypatch.setattr(pose_mode, "build_stream_pair_pack", keep)
    lcfg = presets.mip360_localize()
    lcfg.tracking = lcfg.tracking.replace(num_iters=12, convergence=0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        _localize(SEEDS[0], lcfg)
    rec = profiling.records()
    spans = {s["id"]: s for s in rec["spans"]}
    project = [s for s in rec["spans"] if s["name"] == "render/project"]
    assert len(project) == 12
    assert all(spans[s["parent"]]["name"] == "refine/render"
               for s in project)
    rebins = [s for s in rec["spans"] if s["name"] == "refine/rebin"]
    assert len(rebins) == len(packs) == 2
    for s, pack in zip(rebins, packs):
        assert s["counts"]["stream_slots"] == pack.params.shape[1]
        assert s["notes"]["kept_al"] == int(pack.kept_al) > 0
    assert rec["counters"]["stream_slots"] == sum(p.params.shape[1]
                                                  for p in packs)
