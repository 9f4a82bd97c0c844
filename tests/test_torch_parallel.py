"""The port's multi-device layer (``gs_localization_torch.parallel``) on
gloo worlds of 2 and 4 CPU ranks against the JAX package's sharded
functions on as many of conftest's 8 virtual devices, and against the
port's own unsharded functions.

Each world is launched once for the module (``tests/torch_parallel_worker.py``,
one process per rank, one intra-op thread each); every rank computes every
case and writes its results. Tolerances:

- against JAX: losses rtol 1e-5; Gaussian gradients atol 5e-3, rtol 1e-2
  (the JAX suite's Gaussian-gradient tolerances; the port's plain K3/K4 and
  JAX's jnp blend sum in other orders), the atol taken relative to the
  leaf's largest |gradient| where that is below 1 (``_grad_close``);
  images atol 3e-5; refined poses
  atol 1e-4 (as tests/test_torch_refine.py) with equal iteration counts;
  radii equal;
- against the port unsharded: tests/test_parallel.py's tolerances (DP and
  2-D gradients atol 1e-5, rtol 1e-4; tile-sharded colour atol 1e-5, depth
  1e-4, tau rtol/atol 1e-4, fields atol 1e-4, rtol 1e-3; refined poses
  atol 1e-5).
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gs_localization_tpu.core.gaussians import GaussianParams as JGaussians
from gs_localization_tpu.loc import TrackingConfig as JTrackingConfig
from gs_localization_tpu.parallel import dp as jdp
from gs_localization_tpu.parallel import gauss_shard as jgs
from gs_localization_tpu.parallel.tile_shard import (
    rasterize_tile_sharded as j_tile_sharded)
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_torch.parallel import dryrun, runtime
from helpers import make_camera
import torch_parallel_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
J_CFG = JConfig(tile_size=16, backend="jnp", **W.RASTER)
GRAD_TOL = dict(atol=5e-3, rtol=1e-2)


def _grad_close(got, want, name):
    """``got`` against JAX's ``want`` at GRAD_TOL, with the atol scaled by
    the leaf's largest |gradient| when that is below 1, so that a leaf of
    small gradients (features_rest) is held to as many digits as one of
    order 1 and never more loosely than GRAD_TOL."""
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, name
    np.testing.assert_allclose(got, want,
                               atol=GRAD_TOL["atol"] * min(1.0, scale),
                               rtol=GRAD_TOL["rtol"], err_msg=name)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Both worlds, launched together, each meeting through its own store
    file (``runtime.local_rendezvous``); -> {world: (rank results, ref)}.
    A failed or timed-out rank fails the fixture with every rank's
    output."""
    out = tmp_path_factory.mktemp("parallel")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for world in WORLDS:
        log_dir = out / f"logs{world}"
        log_dir.mkdir()
        init = runtime.local_rendezvous(out)
        procs += dryrun.start_ranks(
            [[sys.executable, os.path.join(REPO, "tests",
                                           "torch_parallel_worker.py"),
              "--rank", str(r), "--world", str(world), "--init", init,
              "--out", str(out)] for r in range(world)], log_dir, cwd=REPO,
            env=env)
    ranks_out = dryrun.wait_ranks(procs, 300)
    assert all(rc == 0 for rc, _ in ranks_out), dryrun.rank_tails(ranks_out)
    res = {}
    for world in WORLDS:
        ranks = [dict(np.load(out / f"w{world}_r{r}.npz"))
                 for r in range(world)]
        ref = dict(np.load(out / f"w{world}_ref.npz"))
        res[world] = (ranks, ref)
    return res


def _j_scene(case):
    return JGaussians.from_arrays(**W.scene_arrays(case), sh_degree=1)


def _j_cameras(case, n):
    _, _, _, _, w, h = W.SCENES[case]
    base = make_camera(w, h)
    return base, jax.vmap(base.with_delta)(jnp.asarray(W.camera_taus(case, n)))


def _same_on_every_rank(ranks, prefix):
    for k in ranks[0]:
        if k.startswith(prefix):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


# ---- dp_train_grads ----------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_dp_train_grads_matches_jax(port, world):
    ranks, ref = port[world]
    _same_on_every_rank(ranks, "dp/")
    n = world * W.CAMS_PER_RANK
    _, cams = _j_cameras("dp", n)
    imgs = jnp.asarray(W.target_images("dp", n))
    mesh = jdp.make_mesh(world)
    loss, grads = jax.jit(lambda g_, c, i: jdp.dp_train_grads(
        mesh, g_, c, i, J_CFG))(_j_scene("dp"), cams, imgs)
    mine = ranks[0]
    np.testing.assert_allclose(mine["dp/loss"], float(loss), rtol=1e-5)
    for k in W.TRAINABLE:
        assert np.abs(mine[f"dp/{k}"]).max() > 0, k
        _grad_close(mine[f"dp/{k}"], grads[k], k)
    # the port unsharded: the mean over every camera on one process
    np.testing.assert_allclose(mine["dp/loss"], ref["dp/loss"], rtol=1e-5)
    for k in W.TRAINABLE:
        np.testing.assert_allclose(mine[f"dp/{k}"], ref[f"dp/{k}"],
                                   atol=1e-5, rtol=1e-4, err_msg=k)


# ---- shard_queries_refine ----------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_shard_queries_refine_matches_jax(port, world):
    ranks, ref = port[world]
    _same_on_every_rank(ranks, "refine/")
    g = _j_scene("refine")
    base, cams = _j_cameras("refine", world)
    target = jax.jit(lambda g_: j_rasterize(g_, base, J_CFG))(g)
    imgs = jnp.tile(target.color[None], (world, 1, 1, 1))
    deps = jnp.tile(target.depth[None], (world, 1, 1))
    masks = jnp.ones(imgs.shape[:3], bool)
    mesh = jdp.make_mesh(world)
    res = jax.jit(lambda c, i, m, d: jdp.shard_queries_refine(
        mesh, g, c, i, m, JTrackingConfig(**W.TRACK), J_CFG, gt_depths=d))(
            cams, imgs, masks, deps)
    mine = ranks[0]
    np.testing.assert_allclose(mine["refine/w2c"], np.asarray(res.w2c),
                               atol=1e-4)
    np.testing.assert_array_equal(mine["refine/num_iters"],
                                  np.asarray(res.num_iters))
    np.testing.assert_allclose(mine["refine/w2c"], ref["refine/w2c"],
                               atol=1e-5)
    np.testing.assert_array_equal(mine["refine/num_iters"],
                                  ref["refine/num_iters"])


# ---- rasterize_tile_sharded --------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_rasterize_tile_sharded_matches_jax(port, world):
    ranks, ref = port[world]
    _same_on_every_rank(ranks, "tile/")
    g = _j_scene("tile")
    base, _ = _j_cameras("tile", 0)
    mesh = jdp.make_mesh(world)

    def loss(g_, tau):
        out = j_tile_sharded(mesh, g_, base.with_delta(tau), J_CFG)
        return jnp.sum(out.color ** 2) + 0.1 * jnp.sum(out.depth ** 2), out

    (_, out), (gg, gt) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True, allow_int=True))(g, jnp.zeros(6))
    mine = ranks[0]
    np.testing.assert_allclose(mine["tile/color"], np.asarray(out.color),
                               atol=3e-5)
    np.testing.assert_allclose(mine["tile/depth"], np.asarray(out.depth),
                               atol=3e-5, rtol=3e-5)
    _grad_close(mine["tile/d_tau"], gt, "tau")
    for k in W.TRAINABLE:
        assert np.abs(mine[f"tile/d_{k}"]).max() > 0, k
        _grad_close(mine[f"tile/d_{k}"], getattr(gg, k), k)
    # the port unsharded (rasterize on one process)
    np.testing.assert_allclose(mine["tile/color"], ref["tile/color"],
                               atol=1e-5)
    np.testing.assert_allclose(mine["tile/depth"], ref["tile/depth"],
                               atol=1e-4)
    np.testing.assert_allclose(mine["tile/d_tau"], ref["tile/d_tau"],
                               rtol=1e-4, atol=1e-4)
    for k in W.TRAINABLE:
        np.testing.assert_allclose(mine[f"tile/d_{k}"], ref[f"tile/d_{k}"],
                                   atol=1e-4, rtol=1e-3, err_msg=k)


# ---- rasterize_gauss_sharded -------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_rasterize_gauss_sharded_matches_jax(port, world):
    ranks, ref = port[world]
    for k in ("gauss/color", "gauss/depth", "gauss/alpha"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    g = _j_scene("gauss")
    base, _ = _j_cameras("gauss", 0)
    mesh = jdp.make_mesh(world, axis="gauss")
    color, depth, alpha, radii = jax.jit(lambda g_: jgs.rasterize_gauss_sharded(
        mesh, g_, base, J_CFG))(g)
    mine = ranks[0]
    for k, v in (("color", color), ("depth", depth), ("alpha", alpha)):
        np.testing.assert_allclose(mine[f"gauss/{k}"], np.asarray(v),
                                   atol=3e-5, rtol=3e-5, err_msg=k)
        np.testing.assert_allclose(mine[f"gauss/{k}"], ref[f"gauss/{k}"],
                                   atol=1e-5 if k != "depth" else 1e-4,
                                   err_msg=k)
    # each rank returns its own block's radii
    radii_t = np.concatenate([r["gauss/radii"] for r in ranks])
    np.testing.assert_array_equal(radii_t, np.asarray(radii))
    np.testing.assert_array_equal(radii_t, ref["gauss/radii"])


# ---- gauss_sharded_loss_and_grads on a (data 2, gauss 2) mesh -----------------

def test_gauss_sharded_loss_and_grads_matches_jax(port):
    ranks, ref = port[4]
    # ranks (data d, gauss j): the loss is the same everywhere, and the
    # gradient of block j is the same on both data rows
    by = {tuple(r["gauss2d/coords"]): r for r in ranks}
    for k in ("gauss2d/loss",) + tuple(f"gauss2d/{t}" for t in W.TRAINABLE):
        for j in (0, 1):
            np.testing.assert_array_equal(by[(1, j)][k], by[(0, j)][k],
                                          err_msg=k)
    g = _j_scene("gauss2d")
    _, cams = _j_cameras("gauss2d", W.N_2D)
    imgs = jnp.asarray(W.target_images("gauss2d", W.N_2D))
    mesh = jgs.make_mesh_2d(2, 2)
    loss, grads = jax.jit(lambda g_, c, i: jgs.gauss_sharded_loss_and_grads(
        mesh, g_, c, i, J_CFG))(g, cams, imgs)
    mine = {k: np.concatenate([by[(0, j)][f"gauss2d/{k}"] for j in (0, 1)])
            for k in W.TRAINABLE}
    np.testing.assert_allclose(by[(0, 0)]["gauss2d/loss"], float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(by[(0, 0)]["gauss2d/loss"], ref["gauss2d/loss"],
                               rtol=1e-5)
    for k in W.TRAINABLE:
        assert np.abs(mine[k]).max() > 0, k
        _grad_close(mine[k], grads[k], k)
        np.testing.assert_allclose(mine[k], ref[f"gauss2d/{k}"], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
