"""Inputs made from the seed reproduce, differ between seeds, and take
seeds wider than 32 bits."""

import numpy as np
import pytest
import torch

from gsbench import registry, scene

SEEDS = [0, 7, 2**31 + 3, 2**40 + 11]


@pytest.mark.parametrize("seed", SEEDS)
def test_map_reproduces(seed):
    spec = dict(registry.config("7scenes-rgbd")["map"], num_gaussians=500)
    a, b = scene.make_map(spec, seed, "cpu"), scene.make_map(spec, seed, "cpu")
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    c = scene.make_map(spec, seed + 1, "cpu")
    assert not torch.equal(a.xyz, c.xyz)
    lo = torch.tensor([r[0] for r in spec["box"]])
    hi = torch.tensor([r[1] for r in spec["box"]])
    assert bool(((a.xyz >= lo) & (a.xyz <= hi)).all())
    assert a.sh.shape == (500, 16, 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_poses_and_tangents_reproduce(seed):
    p = scene.moved_poses(8, 0.1, 0.03, seed, 1)
    q = scene.moved_poses(8, 0.1, 0.03, seed, 1)
    assert all(np.array_equal(a, b) for a, b in zip(p, q))
    for w2c in p:       # moved by exactly 0.1 m / 0.03 rad
        rot = w2c[:3, :3]
        angle = np.arccos(np.clip((np.trace(rot) - 1) / 2, -1, 1))
        assert abs(angle - 0.03) < 1e-9
        assert np.allclose(rot @ rot.T, np.eye(3), atol=1e-12)
    t = scene.init_tangents(8, 0.01, 0.02, seed, 2)
    assert np.array_equal(t, scene.init_tangents(8, 0.01, 0.02, seed, 2))
    assert ((np.abs(t) >= 0.01) & (np.abs(t) <= 0.02)).all()
    assert not np.array_equal(t, scene.init_tangents(8, 0.01, 0.02, seed, 3))


def test_query_order_and_sample_streams_differ():
    a = scene.rng(5, 4).permutation(32)
    assert np.array_equal(a, scene.rng(5, 4).permutation(32))
    assert not np.array_equal(a, scene.rng(6, 4).permutation(32))
