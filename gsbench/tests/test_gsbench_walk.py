"""``reference/walk.py`` against the accepted plain reference on the CPU in
float64: its blend and blend VJP against ``splat``'s, and its refinement
against ``track.refine``.

The map is dense and nearly opaque in a 45x37 frame (a partial tile in
each direction): every tile lists 600 to 1,200 pairs and its pixels
saturate within the first few hundred, so the walk stops early. Each case
sets the walk's step and the block size so that some walk takes several
steps, carrying the log transmittance from one to the next, before it
stops, and (in the second case) so that the tiles fall into several
blocks that stop apart.
"""

import pytest
import torch

from gs_localization_torch.pipelines import presets
from gsbench import registry, scene
from gsbench.reference import splat, track, walk

SENSOR = {"width": 45, "height": 37, "fx": 40.0, "fy": 40.0, "cx": 22.5,
          "cy": 18.5}
MAP = {"num_gaussians": 2500, "sh_degree": 1,
       "box": [[-3.0, 3.0], [-2.5, 2.5], [1.5, 6.0]],
       "log_scale": [-2.0, -1.0], "rgb": [0.05, 0.95], "sh_rest_std": 0.05,
       "opacity_logit": [0.0, 3.0]}
SEED = 3
# (STEP, BLOCK_ELEMS, blocks): one block of all 9 tiles walked 128 lanes
# a step; five blocks of at most two tiles walked 16 lanes a step
CASES = [(128, splat.BLOCK_ELEMS, 1), (16, 2 * 16 * 256, 5)]
# float64 sums that differ only in how the running log sum is associated:
# the gaps read below 1e-15 relative; a lane skipped or added reads 1e-3
REL = 1e-12


def _gap(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.fixture(scope="module")
def frame():
    m = scene.make_map(MAP, SEED, "cpu").to(torch.float64)
    cam = scene.camera(SENSOR, torch.eye(4, dtype=torch.float64))
    scr = splat.project(m, cam)
    return scr.table, splat.bin_tiles(scr, cam), cam


@pytest.fixture
def case(request, monkeypatch):
    """Sets the walk's step and the block size; counts the walk's steps
    (one ``log1p`` a step) against the steps of a walk to the end."""
    step, elems, blocks = request.param
    monkeypatch.setattr(walk, "STEP", step)
    monkeypatch.setattr(splat, "BLOCK_ELEMS", elems)
    steps = [0]
    log1p = torch.log1p

    def counted(x):
        steps[0] += 1
        return log1p(x)

    def walked(fn, *args):
        steps[0] = 0
        with monkeypatch.context() as mp:
            mp.setattr(walk.torch, "log1p", counted)
            out = fn(*args)
        return out, steps[0]

    walked.blocks = blocks
    return walked


@pytest.mark.parametrize("case", CASES, indirect=True)
def test_walk_blend_is_splat_blend(frame, case):
    table, tiles, cam = frame
    ref = splat.blend(table, tiles, cam)
    got, steps = case(walk.blend, table, tiles, cam)
    blocks = walk._blocks(tiles)
    full = sum(-(-lanes // walk.STEP) for _, lanes in blocks)
    assert len(blocks) == case.blocks
    assert 1 < steps < full, (steps, full)   # walked on, and stopped early
    assert ref.evaluated < 256 * int(tiles.start[-1])
    assert (got.evaluated, got.applied) == (ref.evaluated, ref.applied)
    for a, b in zip(got[:3], ref[:3]):
        assert _gap(a, b) < REL


@pytest.mark.parametrize("case", CASES, indirect=True)
def test_walk_blend_vjp_is_splat_blend_vjp(frame, case):
    table, tiles, cam = frame
    gen = torch.Generator().manual_seed(SEED)
    h, w = cam.height, cam.width
    g = [torch.randn(s, generator=gen, dtype=torch.float64)
         for s in ((h, w, 3), (h, w), (h, w))]
    ref = splat.blend_vjp(table, tiles, cam, *g)
    got, steps = case(walk.blend_vjp, table, tiles, cam, *g)
    assert steps > 1
    assert _gap(got, ref) < REL


def test_walk_refine_is_track_refine():
    """The mip360 preset's 50 iterations (rebins every 10) on one query:
    the same pose, iterations, first loss and first gradient."""
    tcfg = registry.driver("localize").tracking_cfg(
        type("St", (), {"lcfg": presets.mip360_localize()})())
    m = scene.make_map(MAP, SEED, "cpu")
    pose = scene.moved_poses(1, 0.1, 0.03, SEED, 1)[0]
    tau = scene.init_tangents(1, 0.01, 0.02, SEED, 2)[0]
    cam = scene.camera(SENSOR, torch.tensor(pose, dtype=torch.float32))
    ((color, _),) = scene.render_targets(m, [cam])
    args = (m.to(torch.float64),
            cam.at(torch.tensor(scene.se3_exp_np(tau) @ pose)),
            color.double(), None, tcfg)
    ref, got = track.refine(*args), walk.refine(*args)
    assert got.iters == ref.iters
    assert _gap(got.w2c, ref.w2c) < REL
    assert _gap(got.loss0, ref.loss0) < REL
    assert _gap(got.grad0, ref.grad0) < REL
