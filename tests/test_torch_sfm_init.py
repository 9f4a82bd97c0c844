"""The port's SfM-init pipeline against the JAX package's: the point model
of ``tests/test_sfm_init.py``'s world (JAX renders, known poses), the PnP
and dense localizers of a held-out view, the depth-corrected point model,
the dense path with ``tests/test_match_dense.py``'s fake dense matcher,
and a ``sparse_matcher`` (the registry's AdaLAM) in place of mutual NN.

Harris keypoints can differ where two responses tie within rounding, so
tracks are compared by their observations: each package's tracks are keyed
by the set of (image, keypoint position) they observe, and the points of
the tracks both packages built must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.pipelines import sfm_init as jinit
from gs_localization_tpu.raster import rasterize
from gs_localization_torch.pipelines import sfm_init as tinit
from helpers import make_camera, random_scene
from test_sfm_init import CFG
from torch_bridge import camera_to_torch

CFG_KW = dict(num_keypoints=512, match_window=5, retrieval_k=4,
              max_reproj_px=3.0, pnp_max_error_px=8.0)


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
def world():
    """``tests/test_sfm_init.py``'s world (the same seed and draws): 900
    small opaque Gaussians and 6 views at 160x120, rendered jitted."""
    rng = np.random.default_rng(21)
    g = random_scene(rng, n=900, sh_degree=1, spread=1.6,
                     z_range=(3.0, 6.0), scale_range=(-4.2, -3.2))
    views = []
    for _ in range(6):
        tau = np.zeros(6, np.float32)
        tau[:3] = 0.08 * rng.standard_normal(3)
        tau[3:] = 0.02 * rng.standard_normal(3)
        views.append(make_camera(160, 120, fov=1.0).with_delta(
            jnp.asarray(tau)))
    render = jax.jit(lambda g, c: rasterize(g, c, CFG))
    outs = [render(g, c) for c in views]
    return (g, views, [np.asarray(o.color) for o in outs],
            [np.asarray(o.depth) for o in outs])


def _tracks_by_observations(mapped):
    kps = [np.asarray(f.keypoints.cpu() if isinstance(f.keypoints,
                                                      torch.Tensor)
                      else f.keypoints) for f in mapped.features]
    obs = {}
    t = mapped.tracks
    for e in range(len(t.track_ids)):
        i, k = int(t.image_idx[e]), int(t.kp_idx[e])
        obs.setdefault(int(t.track_ids[e]), set()).add(
            (i, float(kps[i][k][0]), float(kps[i][k][1])))
    return {frozenset(v): tid for tid, v in obs.items()}


def _same_point_model(mj, mt) -> None:
    nj, nt = int(mj.valid.sum()), int(mt.valid.sum())
    assert abs(nt - nj) <= 0.01 * nj, (nj, nt)
    bj, bt = _tracks_by_observations(mj), _tracks_by_observations(mt)
    both = [k for k in bj if k in bt and mj.valid[bj[k]]
            and mt.valid[bt[k]]]
    assert len(both) >= 0.95 * nj, (len(both), nj)
    a = np.array([bj[k] for k in both])
    b = np.array([bt[k] for k in both])
    np.testing.assert_allclose(mt.points[b], mj.points[a], atol=1e-4)
    np.testing.assert_allclose(mt.track_colors[b], mj.track_colors[a],
                               atol=1e-6)


def _K(cam) -> np.ndarray:
    return np.array([[float(cam.fx), 0, float(cam.cx)],
                     [0, float(cam.fy), float(cam.cy)], [0, 0, 1.0]])


def _same_pose(rj, rt) -> None:
    (qj, tj, ij), (qt, tt, it) = rj, rt
    assert it["method"] == ij["method"]
    assert it["retrieved"] == ij["retrieved"]
    np.testing.assert_allclose(qt, qj, atol=1e-3)
    np.testing.assert_allclose(tt, tj, atol=1e-3)


@pytest.mark.parametrize("depth", [False, True], ids=["plain", "depth"])
def test_point_model_and_pnp_localizer_match_jax(world, depth):
    _, views, renders, depths = world
    tviews = [camera_to_torch(v) for v in views]
    n = 4 if depth else 5
    kw = dict(CFG_KW, depth_correct=depth)
    if depth:
        kw.update(num_keypoints=256, match_window=4, retrieval_k=3)
    dm = depths[:n] if depth else None
    logs_j, logs_t = [], []
    mj = jinit.build_point_model(renders[:n], views[:n],
                                 jinit.SfmInitConfig(**kw), depth_maps=dm,
                                 log_fn=logs_j.append)
    mt = tinit.build_point_model(renders[:n], tviews[:n],
                                 tinit.SfmInitConfig(**kw), depth_maps=dm,
                                 log_fn=logs_t.append, device="cpu")
    assert logs_t == logs_j
    np.testing.assert_allclose(mt.global_descs, mj.global_descs, atol=1e-6)
    _same_point_model(mj, mt)
    assert int(mt.valid.sum()) > (10 if depth else 40)
    if depth:
        return
    q = 5
    rj = jinit.localize_query_pnp(renders[q], _K(views[q]), mj, views[:n],
                                  jinit.SfmInitConfig(**kw))
    rt = tinit.localize_query_pnp(renders[q], _K(views[q]), mt, tviews[:n],
                                  tinit.SfmInitConfig(**kw), device="cpu")
    _same_pose(rj, rt)
    assert rt[2]["method"] == "pnp"


def test_sparse_matcher_matches_jax(world):
    """``sparse_matcher`` replaces mutual-NN matching in both packages: the
    registry's AdaLAM (host-side, the same bits in both) with the image
    size bound, for the point model and the PnP localizer."""
    from gs_localization_tpu.sfm.registry import get_matcher as jget
    from gs_localization_torch.sfm.registry import get_matcher as tget

    _, views, renders, _ = world
    tviews = [camera_to_torch(v) for v in views]
    n, size = 5, (160, 120)
    mj_fn, mt_fn = jget("adalam"), tget("adalam")
    calls = []

    def sparse_t(f0, f1):
        calls.append(1)
        return mt_fn(f0, f1, size, size)

    mj = jinit.build_point_model(
        renders[:n], views[:n], jinit.SfmInitConfig(**CFG_KW),
        sparse_matcher=lambda f0, f1: mj_fn(f0, f1, size, size),
        log_fn=lambda m: None)
    mt = tinit.build_point_model(
        renders[:n], tviews[:n], tinit.SfmInitConfig(**CFG_KW),
        sparse_matcher=sparse_t, log_fn=lambda m: None, device="cpu")
    assert calls
    _same_point_model(mj, mt)
    assert int(mt.valid.sum()) > 20
    q = 5
    rj = jinit.localize_query_pnp(
        renders[q], _K(views[q]), mj, views[:n], jinit.SfmInitConfig(**CFG_KW),
        sparse_matcher=lambda f0, f1: mj_fn(f0, f1, size, size))
    rt = tinit.localize_query_pnp(
        renders[q], _K(views[q]), mt, tviews[:n],
        tinit.SfmInitConfig(**CFG_KW), sparse_matcher=sparse_t,
        device="cpu")
    _same_pose(rj, rt)


def test_dense_path_matches_jax():
    """build_point_model(dense_matcher=...) and localize_query_dense with
    ``tests/test_match_dense.py``'s fake LoFTR (the true projections of 80
    points plus noise, here drawn from a seed per image pair)."""
    rng = np.random.default_rng(0)
    n_pts = 80
    pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(4, 6, n_pts)], 1)
    cams = [make_camera(320, 240, fov=1.0, t=np.array([0.3 * i - 0.45, 0, 0]))
            for i in range(4)]
    qcam = make_camera(320, 240, fov=1.0, t=np.array([0.1, 0.05, 0.0]))
    imgs = [rng.uniform(0, 1, (240, 320, 3)).astype(np.float32)
            for _ in range(5)]
    index = {id(img): i for i, img in enumerate(imgs)}
    allcams = cams + [qcam]

    def project(cam):
        w2c = np.asarray(cam.w2c)
        pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
        uv = pc @ _K(cam).T
        return uv[:, :2] / uv[:, 2:3]

    def fake_loftr(img0, img1):
        a, b = index[id(img0)], index[id(img1)]
        r = np.random.default_rng(100 * a + b)
        noise = r.normal(0, 0.15, (n_pts, 2))
        return (project(allcams[a]) + noise, project(allcams[b]) + noise,
                r.uniform(0.5, 1.0, n_pts))

    kw = dict(dense_max_error=1.0, dense_cell_size=1.0, retrieval_k=3)
    logs_j, logs_t = [], []
    mj = jinit.build_point_model(imgs[:4], cams, jinit.SfmInitConfig(**kw),
                                 dense_matcher=fake_loftr,
                                 log_fn=logs_j.append)
    tcams = [camera_to_torch(c) for c in cams]
    mt = tinit.build_point_model(imgs[:4], tcams, tinit.SfmInitConfig(**kw),
                                 dense_matcher=fake_loftr,
                                 log_fn=logs_t.append, device="cpu")
    assert logs_t == logs_j
    _same_point_model(mj, mt)
    assert mt.valid.sum() >= 0.7 * n_pts
    rj = jinit.localize_query_dense(imgs[4], _K(qcam), mj, cams, fake_loftr,
                                    imgs[:4], jinit.SfmInitConfig(**kw))
    rt = tinit.localize_query_dense(imgs[4], _K(qcam), mt, tcams,
                                    fake_loftr, imgs[:4],
                                    tinit.SfmInitConfig(**kw), device="cpu")
    _same_pose(rj, rt)
    assert rt[2]["method"] == "pnp"
    assert np.linalg.norm(rt[1] - np.asarray(qcam.w2c)[:3, 3]) < 0.05


@pytest.fixture(scope="module")
def speckle_world():
    """A dense speckle of small Gaussians (as the card phase's bench map
    renders) and 5 views at 256x192: LoFTR's 512 slots need as many coarse
    cells, and its 8-px cells need texture."""
    rng = np.random.default_rng(31)
    g = random_scene(rng, n=6000, sh_degree=1, spread=1.6,
                     z_range=(3.0, 6.0), scale_range=(-4.0, -3.0))
    views = []
    for _ in range(5):
        tau = np.zeros(6, np.float32)
        tau[:3] = 0.06 * rng.standard_normal(3)
        tau[3:] = 0.015 * rng.standard_normal(3)
        views.append(make_camera(256, 192, fov=1.0).with_delta(
            jnp.asarray(tau)))
    render = jax.jit(lambda g, c: rasterize(g, c, CFG))
    return views, [np.asarray(render(g, c).color) for c in views]


def test_loftr_dense_path_matches_jax(speckle_world):
    """build_point_model(dense_matcher=...) and localize_query_dense with
    the registry's LoFTR conf in both packages, on the same weights: the
    census-matching LoFTR of ``chip_smoke.sharp_loftr_params`` (at random
    weights no pair matches). LoFTR's image0 keypoints differ between the
    packages by ~3e-4 px, so an aggregated keypoint can fall on the other
    side of a 1-px quantization boundary: the point models are compared by
    their tracks' observations (counts within 1 %, 95 % of the tracks
    shared, points within 1e-4), the poses within 1e-3."""
    from chip_smoke import sharp_loftr_params
    from gs_localization_tpu.sfm.registry import get_dense_matcher as jget
    from gs_localization_torch.sfm.loftr import loftr_from_jax_params
    from gs_localization_torch.sfm.registry import get_dense_matcher as tget

    views, renders = speckle_world
    params = sharp_loftr_params(0)
    jm, jcfg = jget("loftr", params=params)
    tm, tcfg = tget("loftr", params=loftr_from_jax_params(params, "cpu"))
    assert tcfg == jcfg
    kw = dict(dense_max_error=jcfg["max_error"],
              dense_cell_size=jcfg["cell_size"], match_window=3,
              retrieval_k=2)
    n = 4
    tviews = [camera_to_torch(v) for v in views]
    logs_j, logs_t = [], []
    mj = jinit.build_point_model(renders[:n], views[:n],
                                 jinit.SfmInitConfig(**kw), dense_matcher=jm,
                                 log_fn=logs_j.append)
    mt = tinit.build_point_model(renders[:n], tviews[:n],
                                 tinit.SfmInitConfig(**kw), dense_matcher=tm,
                                 log_fn=logs_t.append, device="cpu")
    assert logs_t[0] == logs_j[0]          # dense-matched pairs, keypoints
    _same_point_model(mj, mt)
    assert int(mt.valid.sum()) > 100
    rj = jinit.localize_query_dense(renders[n], _K(views[n]), mj, views[:n],
                                    jm, renders[:n], jinit.SfmInitConfig(**kw))
    rt = tinit.localize_query_dense(renders[n], _K(views[n]), mt, tviews[:n],
                                    tm, renders[:n],
                                    tinit.SfmInitConfig(**kw), device="cpu")
    _same_pose(rj, rt)
    assert rt[2]["method"] == "pnp"
    assert np.linalg.norm(rt[1] - np.asarray(views[n].w2c)[:3, 3]) < 0.05
