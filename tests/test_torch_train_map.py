"""Port train_map against the JAX package's train_map: 30 iterations of the
host loop (random camera choice, SH bumps, one densify round that clones
and splits nothing, held-out PSNR, a PLY snapshot) on the same seeded
scene, and the snapshot's round trip through ``load_map``.

The JAX side trains on its CPU default (``backend="jnp"``); the port on
the same ``bin_gaussians`` lists through the plain versions of K3/K4. Adam
with eps 1e-15 moves a parameter whose gradient is rounding noise by ~lr
per step in a direction the summation order picks (the rotations of
from_pcd's isotropic Gaussians, first of all), so the two runs are held on
what they render and on their losses, not parameter by parameter.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.data.scene import CameraInfo as JCameraInfo
from gs_localization_tpu.data.scene import SceneInfo as JSceneInfo
from gs_localization_tpu.pipelines.train_map import (
    TrainPipelineConfig as JPipelineConfig, train_map as j_train_map)
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_torch.data.scene import (CameraInfo, SceneInfo,
                                              compute_scene_extent)
from gs_localization_torch.pipelines.localize import load_map
from gs_localization_torch.pipelines.train_map import (TrainPipelineConfig,
                                                       train_map)
from gs_localization_torch.raster import RasterizerConfig, rasterize
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, np_of

J_CFG = JConfig(max_pairs=1 << 12, max_per_tile=256, chunk=32, backend="jnp",
                use_stream=False)
CFG = RasterizerConfig(max_pairs=1 << 12, max_per_tile=256, pallas_chunk=32,
                       use_stream=False)
PIPE = dict(iterations=30, sh_degree=1, capacity_multiplier=2.0,
            densify_from=10, densify_until=30, densification_interval=20,
            opacity_reset_interval=10_000, sh_up_interval=10,
            test_iterations=(30,), save_iterations=(30,), log_every=10,
            seed=3, percent_dense=1.0)
EXTENT = 5.0    # percent_dense * extent above every scale: clones only


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: its loops run many small CPU
    ops, and when each spreads over a thread pool, the suite's parallel
    workers (more threads than cores) make every op wait on a barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    target = random_scene(np.random.default_rng(11), n=80, sh_degree=1)
    rng = np.random.default_rng(12)
    cams = [make_camera(48, 32)] + [
        make_camera(48, 32).with_delta(jnp.asarray(
            rng.uniform(-0.03, 0.03, 6), jnp.float32)) for _ in range(2)]
    render = jax.jit(lambda c: j_rasterize(target, c, J_CFG))
    imgs = [np.asarray(render(c).color) for c in cams]
    pts = (np.asarray(target.xyz)[:50]
           + 0.05 * rng.standard_normal((50, 3))).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (50, 3)).astype(np.float32)

    def loader(info):
        return imgs[info.uid], None

    jscene = JSceneInfo(
        train_cameras=[JCameraInfo(uid=i, name=f"c{i}", camera=c)
                       for i, c in enumerate(cams[:2])],
        test_cameras=[JCameraInfo(uid=2, name="c2", camera=cams[2])],
        points=pts, colors=cols, extent=EXTENT)
    tscene = SceneInfo(
        train_cameras=[CameraInfo(uid=i, name=f"c{i}",
                                  camera=camera_to_torch(c))
                       for i, c in enumerate(cams[:2])],
        test_cameras=[CameraInfo(uid=2, name="c2",
                                 camera=camera_to_torch(cams[2]))],
        points=pts, colors=cols, extent=EXTENT)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("pt")
    jlogs, tlogs = [], []
    gj = j_train_map(jscene, str(jdir), JPipelineConfig(**PIPE),
                     raster_cfg=J_CFG, image_loader=loader,
                     log_fn=jlogs.append)
    gt = train_map(tscene, str(tdir), TrainPipelineConfig(**PIPE),
                   raster_cfg=CFG, image_loader=loader, log_fn=tlogs.append,
                   device="cpu")
    return dict(gj=gj, gt=gt, jlogs=jlogs, tlogs=tlogs, tdir=tdir,
                cam=camera_to_torch(cams[2]), jcam=cams[2])


def _numbers(logs, pattern):
    return [float(m.group(1)) for line in logs
            for m in [re.search(pattern, line)] if m]


def test_train_map_matches_jax(runs):
    gj, gt, jlogs, tlogs = runs["gj"], runs["gt"], runs["jlogs"], runs["tlogs"]
    # the same loop: capacity, live count, SH degree, the densify round
    assert gt.capacity == gj.capacity == 1024
    assert int(gt.num_live) == int(gj.num_live) > 50
    assert gt.sh_degree == gj.sh_degree == 1
    dens = [line for line in tlogs if "densify:" in line]
    assert len(dens) == 1 and " split 0 " in dens[0]
    assert int(re.search(r"cloned (\d+)", dens[0]).group(1)) > 0
    # losses at iterations 10, 20, 30 and the held-out PSNR at 30
    loss_j = _numbers(jlogs, r"loss=([0-9.]+)")
    loss_t = _numbers(tlogs, r"loss=([0-9.]+)")
    assert len(loss_t) == len(loss_j) == 3
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)   # 5 decimals
    psnr_j = _numbers(jlogs, r"test PSNR ([0-9.]+)")
    psnr_t = _numbers(tlogs, r"test PSNR ([0-9.]+)")
    assert len(psnr_t) == 1
    np.testing.assert_allclose(psnr_t, psnr_j, atol=0.01)   # 2 decimals
    # both final maps render the held-out view alike (2e-6 apart on this
    # scene; the tolerance leaves room for the Adam noise above)
    with torch.no_grad():
        ct = rasterize(gt, runs["cam"], CFG).color
    cj = jax.jit(lambda g: j_rasterize(g, runs["jcam"], J_CFG).color)(gj)
    np.testing.assert_allclose(np_of(ct), np.asarray(cj), atol=1e-4)


def test_snapshot_round_trips(runs):
    gt, tdir = runs["gt"], runs["tdir"]
    path = tdir / "gs_map" / "iteration_30" / "point_cloud.ply"
    assert path.exists()
    back = load_map(str(path), device="cpu")
    assert back.capacity == int(gt.num_live)
    with torch.no_grad():
        a = rasterize(gt, runs["cam"], CFG)
        b = rasterize(back, runs["cam"], CFG)
    np.testing.assert_allclose(np_of(b.color), np_of(a.color), atol=1e-5)
    np.testing.assert_allclose(np_of(b.depth), np_of(a.depth), atol=1e-5)


def test_pseudo_views_are_refused():
    """No pseudo views (and no estimator call) for a scene with at least
    ``fewshot_threshold`` training views, even with an estimator given."""
    cam = camera_to_torch(make_camera(48, 32))
    scene = SceneInfo([CameraInfo(uid=i, name=f"c{i}", camera=cam)
                       for i in range(2)], [],
                      np.random.default_rng(0).uniform(
                          -1, 1, (8, 3)).astype(np.float32) + [0, 0, 4],
                      np.full((8, 3), 0.5, np.float32))
    logs, calls = [], []
    train_map(scene, cfg=TrainPipelineConfig(
        iterations=4, sh_degree=0, fewshot_threshold=2,
        sample_pseudo_interval=1, start_sample_pseudo=0,
        densify_from=100, opacity_reset_interval=10_000,
        test_iterations=(), save_iterations=(), log_every=100),
        raster_cfg=CFG, image_loader=lambda info: (np.zeros(
            (32, 48, 3), np.float32), None),
        depth_estimator=lambda rgb: calls.append(1) or rgb[..., 0],
        log_fn=logs.append, device="cpu")
    assert calls == [] and not any("few-shot" in line for line in logs)
    assert compute_scene_extent(np.array([[0.0, 0, 0], [2.0, 0, 0]])) == \
        pytest.approx(1.1)


def test_camera_subset_swap_and_default_loader(tmp_path):
    """Images and depths read from disk by the default loader; a camera cap
    with one swap."""
    from PIL import Image

    rng = np.random.default_rng(5)
    infos = []
    for i in range(3):
        img = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
        dep = rng.integers(500, 4000, (32, 48)).astype(np.uint16)
        dep[0, 0] = 65535                        # the invalid-depth value
        Image.fromarray(img).save(tmp_path / f"c{i}.png")
        Image.fromarray(dep).save(tmp_path / f"d{i}.png")
        infos.append(CameraInfo(uid=i, name=f"c{i}",
                                camera=camera_to_torch(make_camera(48, 32)),
                                image_path=str(tmp_path / f"c{i}.png"),
                                depth_path=str(tmp_path / f"d{i}.png")))
    pts = rng.uniform(-1, 1, (20, 3)).astype(np.float32) + [0, 0, 4]
    scene = SceneInfo(infos, [], pts.astype(np.float32),
                      np.full((20, 3), 0.5, np.float32))
    logs = []
    cfg = TrainPipelineConfig(
        iterations=4, sh_degree=0, max_cameras=2, camera_swap_iteration=3,
        densify_from=100, opacity_reset_interval=10_000, test_iterations=(),
        save_iterations=(), log_every=2)
    out = train_map(scene, cfg=cfg, raster_cfg=CFG, log_fn=logs.append,
                    device="cpu")
    # the default loader says it reads with PIL, then the camera cap
    assert logs[0].startswith("image loader: PIL")
    assert logs[1] == "too-large scene: training on 2/3 cameras"
    assert "[3] swapped to a fresh 2-camera subset" in logs
    assert len(_numbers(logs, r"loss=([0-9.]+)")) == 2
    assert int(out.num_live) == 20
