"""Port preprocess against the JAX package on the same seeded scene."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.core import se3 as jse3
from gs_localization_tpu.raster.preprocess import (
    build_cov3d as j_build_cov3d, preprocess as j_preprocess)
from gs_localization_torch.raster.preprocess import build_cov3d, preprocess
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch, np_of

FLOATS = ("depths", "means2d", "conic", "rgb", "opacity")
INTS = ("rect", "tiles_touched", "radii")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    # wide spread and z from behind the camera: near culls, frustum edges,
    # padded dead slots (capacity > n)
    g = random_scene(rng, n=300, sh_degree=3, spread=2.5, z_range=(-1.0, 7.0),
                     scale_range=(-3.5, -1.5), capacity=320)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.05, -0.1, 0.02])))
    cam = make_camera(96, 64, fov=1.1, R=R, t=np.array([0.1, -0.05, 0.2],
                                                       np.float32))
    return g, cam, gaussians_to_torch(g), camera_to_torch(cam)


def test_cov3d_matches_jax(scene):
    g, _, tg, _ = scene
    np.testing.assert_allclose(
        np_of(build_cov3d(tg.get_scaling, tg.get_rotation, 1.3)),
        np_of(j_build_cov3d(g.get_scaling, g.get_rotation, 1.3)),
        atol=1e-7, rtol=1e-5)


def test_preprocess_matches_jax(scene):
    g, cam, tg, tcam = scene
    pj = j_preprocess(g, cam, tile_size=16)
    pt = preprocess(tg, tcam, tile_size=16)
    valid = np_of(pj.valid)
    np.testing.assert_array_equal(np_of(pt.valid), valid)
    assert 50 < valid.sum() < 300      # culls on both sides of the frustum
    for name in FLOATS:
        # rtol 1e-6 beside atol 1e-5: pixel coordinates reach ~100, where
        # one float32 ulp is ~8e-6 and the two frameworks' matmuls round
        # differently
        np.testing.assert_allclose(np_of(getattr(pt, name))[valid],
                                   np_of(getattr(pj, name))[valid],
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    for name in INTS:
        np.testing.assert_array_equal(np_of(getattr(pt, name))[valid],
                                      np_of(getattr(pj, name))[valid],
                                      err_msg=name)
    # culled rows touch no tiles on either side
    assert (np_of(pt.tiles_touched)[~valid] == 0).all()
    # radii keep the 3-sigma visibility semantics everywhere
    np.testing.assert_array_equal(np_of(pt.radii), np_of(pj.radii))


def test_w2c_gradients_match_jax(scene):
    g, cam, tg, tcam = scene
    valid = np_of(j_preprocess(g, cam).valid)
    rng = np.random.default_rng(2)
    wts = {n: rng.standard_normal(np_of(getattr(j_preprocess(g, cam), n))
                                  .shape).astype(np.float32)
           for n in ("depths", "means2d", "conic", "rgb")}
    vmask = valid.astype(np.float32)

    def jloss(w2c):
        p = j_preprocess(g, cam.replace(w2c=w2c))
        return sum(jnp.sum(getattr(p, n) * wts[n]
                           * vmask.reshape((-1,) + (1,) * (wts[n].ndim - 1)))
                   for n in wts)

    gj = jax.grad(jloss)(cam.w2c)
    w2c = tcam.w2c.clone().requires_grad_()
    p = preprocess(tg, tcam.replace(w2c=w2c))
    vm = torch.tensor(vmask)
    loss = sum((getattr(p, n) * torch.tensor(wts[n])
                * vm.reshape((-1,) + (1,) * (wts[n].ndim - 1))).sum()
               for n in wts)
    loss.backward()
    assert torch.isfinite(w2c.grad).all()
    np.testing.assert_allclose(np_of(w2c.grad), np_of(gj), rtol=1e-4,
                               atol=1e-3)


def test_nonfinite_rows_cull_cleanly(scene):
    _, _, tg, tcam = scene
    xyz = tg.xyz.clone()
    xyz[3] = float("nan")
    xyz[7, 2] = float("inf")
    p = preprocess(tg.replace(xyz=xyz), tcam)
    assert not bool(p.valid[3]) and not bool(p.valid[7])
    # no INT_MIN garbage from NaN casts reaches the tile math
    assert int(p.rect.min()) >= 0 and int(p.rect.max()) <= 6
    assert int(p.tiles_touched[3]) == 0 and int(p.tiles_touched[7]) == 0
