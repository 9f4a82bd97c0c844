"""The work count against a count made by hand on a tiny map."""

import math

import pytest
import torch

from gsbench import workcount
from gsbench.reference import splat


def _one_tile_map(opacities, depths):
    n = len(opacities)
    xyz = torch.tensor([[0.0, 0.0, d] for d in depths], dtype=torch.float64)
    return splat.Map(
        xyz, torch.full((n, 3), math.log(0.3), dtype=torch.float64),
        torch.tensor([[1.0, 0, 0, 0]] * n, dtype=torch.float64),
        torch.logit(torch.tensor(opacities, dtype=torch.float64)),
        torch.zeros((n, 1, 3), dtype=torch.float64), 0)


def _cam():
    return splat.Cam(torch.eye(4, dtype=torch.float64), 20.0, 20.0, 8.0, 8.0,
                     16, 16)


def test_hand_count_one_tile():
    """Three Gaussians on the axis of a one-tile camera. Opacities 0.99
    saturate fast: after two at the centre T = 1e-4 exactly is reached, so
    the count is what the per-pixel walk reaches."""
    m = _one_tile_map([0.5, 0.5, 0.5], [2.0, 3.0, 4.0])
    cam = _cam()
    scr = splat.project(m, cam)
    tiles = splat.bin_tiles(scr, cam)
    assert tiles.gauss.tolist() == [0, 1, 2]          # depth order
    out = splat.blend(scr.table, tiles, cam)
    tab = scr.table
    # by hand: per pixel, walk the three in order
    ev = ap = 0
    for py in range(16):
        for px in range(16):
            log_t = 0.0
            for g in range(3):
                dx, dy = float(tab[g, 0]) - px, float(tab[g, 1]) - py
                a, b, c = (float(tab[g, k]) for k in (2, 3, 4))
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(0.99, float(tab[g, 5]) * math.exp(min(power, 0)))
                if log_t < math.log(1e-4):
                    break
                ev += 1
                if power > 0 or alpha < 1 / 255:
                    continue
                if log_t + math.log1p(-alpha) < math.log(1e-4):
                    break
                ap += 1
                log_t += math.log1p(-alpha)
    assert (out.evaluated, out.applied) == (ev, ap)
    r = workcount.count(out, tiles, 16, 16)
    assert r == workcount.Render(ev, ap, 3, 3, 256)
    assert r.blend_fwd_flops() == 10 * ev + 13 * ap
    assert r.blend_bwd_flops() == 50 * ap
    assert r.blend_fwd_bytes() == 4 * 3 + 40 * 3 + 20 * 256


def test_saturation_stops_the_count():
    """Ten opaque Gaussians at the same place: a pixel at the centre
    composites two (0.99 each leaves T = 1e-4 after two, and the third
    would take it below) and reaches the third."""
    m = _one_tile_map([0.9999] * 10, [2.0 + 0.1 * i for i in range(10)])
    m = m._replace(log_scale=torch.full((10, 3), math.log(5.0),
                                        dtype=torch.float64))
    cam = _cam()
    scr = splat.project(m, cam)
    out = splat.blend(scr.table, splat.bin_tiles(scr, cam), cam)
    assert out.applied <= 2 * 256
    assert out.evaluated <= 3 * 256
    assert out.applied >= 256


def test_min_seconds_names_its_bound():
    p = workcount.PEAKS["H100"]
    t, by = workcount.min_seconds(67e12, 1.0, p)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = workcount.min_seconds(1.0, 3.35e12, p)
    assert by == "bytes" and t == pytest.approx(1.0)
    assert workcount.peak("NVIDIA H100 80GB HBM3") is p
    with pytest.raises(KeyError):
        workcount.peak("cpu")
