"""The port's host-side SfM geometry against the JAX package's: the same
inputs and seeds give the same bits.

PnP-RANSAC (``tests/test_sfm.py``'s cases; the quaternion goes through each
package's ``rotmat_to_quat`` and is held to 1e-7), epipolar filtering,
track building, known-pose triangulation and depth correction, the pair
generators, the Umeyama alignment, the AdaLAM filter
(``tests/test_adalam.py``'s cases) and the dense-match aggregation
(``tests/test_match_dense.py``'s cases).
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gs_localization_tpu.data import colmap as jcolmap
from gs_localization_tpu.sfm import adalam as jadalam
from gs_localization_tpu.sfm import match_dense as jdense
from gs_localization_tpu.sfm import pairs as jpairs
from gs_localization_tpu.sfm import pnp as jpnp
from gs_localization_tpu.sfm import triangulate as jtri
from gs_localization_tpu.sfm.evaluate import umeyama_alignment as jumeyama
from gs_localization_tpu.sfm.features import Features as JFeatures
from gs_localization_torch.data import colmap as tcolmap
from gs_localization_torch.sfm import adalam as tadalam
from gs_localization_torch.sfm import match_dense as tdense
from gs_localization_torch.sfm import pairs as tpairs
from gs_localization_torch.sfm import pnp as tpnp
from gs_localization_torch.sfm import triangulate as ttri
from gs_localization_torch.sfm.evaluate import umeyama_alignment as tumeyama
from gs_localization_torch.sfm.features import Features as TFeatures
from test_adalam import H, W, _synthetic
import test_sfm
from test_sfm import _project


def _same(a, b) -> None:
    """Equal results: tuples, lists, dicts and arrays compared exactly."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("case", ["outliers", "few_points", "all_outliers"])
def test_pnp_ransac_equals_jax(case):
    rng = np.random.default_rng(0)
    kw = {}
    if case == "outliers":
        X, uv, _, _, K = test_sfm.TestPnP()._scene(rng)
        kw = dict(max_error_px=6.0, seed=1)
    elif case == "few_points":
        X, uv, K = np.zeros((4, 3)), np.zeros((4, 2)), np.eye(3)
    else:
        X = rng.uniform(-2, 2, (50, 3)) + [0, 0, 5]
        uv = rng.uniform(0, 640, (50, 2))
        K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
        kw = dict(max_error_px=2.0, min_inliers=15, max_hypotheses=512)
    rj = jpnp.pnp_ransac(uv, X, K, **kw)
    rt = tpnp.pnp_ransac(uv, X, K, **kw)
    assert (rt.success, rt.num_inliers) == (rj.success, rj.num_inliers)
    _same(rj.tvec, rt.tvec)
    _same(rj.inlier_mask, rt.inlier_mask)
    np.testing.assert_allclose(rt.qvec, rj.qvec, rtol=0, atol=1e-7)
    if case == "outliers":
        assert rt.success and rt.num_inliers > 120


def _views(rng, n_pts, n_views, rot, shift, dz):
    """Points in front of n_views cameras on a line, their noisy pixels."""
    X = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                  rng.uniform(4, 6, n_pts)], 1)
    K = np.array([[400.0, 0, 64], [0, 400, 48], [0, 0, 1]])
    w2cs, kps = [], []
    for v in range(n_views):
        w2c = np.eye(4)
        w2c[:3, :3] = Rotation.from_rotvec(
            [0, rot * (v - 1.5), 0]).as_matrix()
        w2c[:3, 3] = [shift * (v - 1.5), 0, dz * v]
        w2cs.append(w2c)
        kps.append(_project(X, w2c[:3, :3], w2c[:3, 3], K)
                   + 0.2 * rng.standard_normal((n_pts, 2)))
    return X, K, np.stack(w2cs), kps


@pytest.mark.parametrize("wrong", [0, 10])
def test_tracks_and_triangulation_equal_jax(wrong):
    """Epipolar filtering of matches with wrong ones mixed in, track
    building, triangulation and depth correction (``tests/test_sfm.py``'s
    TestTriangulation and TestEpipolarFilter scenes)."""
    rng = np.random.default_rng(4)
    n_pts, n_views = 40, 4
    X, K, w2cs, kps = _views(rng, n_pts, n_views, 0.12, 0.3, 0.05)
    pair_j, pair_t = {}, {}
    for v in range(n_views - 1):
        m = np.stack([np.arange(n_pts)] * 2, 1)
        if wrong:
            m = np.concatenate([m, np.stack([
                rng.permutation(n_pts)[:wrong],
                rng.permutation(n_pts)[:wrong]], 1)])
        args = (m, kps[v], kps[v + 1], w2cs[v], w2cs[v + 1], K, K)
        pair_j[(v, v + 1)] = jtri.epipolar_filter_matches(
            *args, max_epip_px=3.0)
        pair_t[(v, v + 1)] = ttri.epipolar_filter_matches(
            *args, max_epip_px=3.0)
    _same(pair_j, pair_t)
    tj = jtri.build_tracks(n_views, [n_pts] * n_views, pair_j)
    tt = ttri.build_tracks(n_views, [n_pts] * n_views, pair_t)
    _same(tuple(tj), tuple(tt))
    Ks = np.tile(K[None], (n_views, 1, 1))
    xj, vj = jtri.triangulate_tracks(tj, kps, w2cs, Ks)
    xt, vt = ttri.triangulate_tracks(tt, kps, w2cs, Ks)
    _same((xj, vj), (xt, vt))
    assert vt.sum() >= n_pts - 10
    depths = [np.full((96, 128), 4.5 + 0.1 * v, np.float32)
              for v in range(n_views)]
    depths[1][40:60, 50:80] = 0.0          # holes: the nearest fallback
    _same(jtri.correct_points_with_depth(xj, tj, w2cs, Ks, depths),
          ttri.correct_points_with_depth(xt, tt, w2cs, Ks, depths))


def _colmap_images(mod, rng, n=7):
    images = {}
    for i in range(n):
        q = Rotation.from_rotvec(0.3 * rng.standard_normal(3)).as_quat()
        images[i + 1] = mod.ColmapImage(
            i + 1, np.roll(q, 1), rng.standard_normal(3), 1, f"im{i}.png",
            np.zeros((5, 2)), rng.integers(-1, 12, 5))
    return images


def test_pairs_and_umeyama_equal_jax():
    names = [f"im{i}.png" for i in range(7)]
    for fn, kw in (("pairs_exhaustive", {}),
                   ("pairs_sequential", dict(window=3)),
                   ("pairs_sequential", dict(window=3, loop=True))):
        _same(getattr(jpairs, fn)(names, **kw),
              getattr(tpairs, fn)(names, **kw))
    ij = _colmap_images(jcolmap, np.random.default_rng(2))
    it = _colmap_images(tcolmap, np.random.default_rng(2))
    _same(jpairs.pairs_from_covisibility(ij, top_k=3),
          tpairs.pairs_from_covisibility(it, top_k=3))
    for thr in (30.0, 60.0):
        got = tpairs.pairs_from_poses(it, num_matched=3,
                                      rotation_threshold=thr)
        _same(jpairs.pairs_from_poses(ij, num_matched=3,
                                      rotation_threshold=thr), got)
        assert got
    rng = np.random.default_rng(3)
    src = rng.standard_normal((20, 3))
    R = Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix()
    dst = 1.7 * src @ R.T + [1.0, 2.0, -0.5] + 1e-3 * rng.standard_normal(
        (20, 3))
    for scale in (True, False):
        _same(jumeyama(src, dst, scale), tumeyama(src, dst, scale))


@pytest.mark.parametrize("case", ["mixed", "outliers_only", "gated"])
def test_adalam_filter_equals_jax(case):
    rng = np.random.default_rng(0)
    kw = {}
    if case == "outliers_only":
        n = 150
        k0, k1 = rng.uniform(0, [W, H], (n, 2)), rng.uniform(0, [W, H],
                                                             (n, 2))
        m0, sc = np.arange(n), rng.uniform(0.3, 1.0, n)
    else:
        k0, k1, m0, sc, inlier = _synthetic(rng, n_in=100, n_out=60)
        if case == "gated":
            n = len(m0)
            kw = dict(scales0=np.ones(n),
                      scales1=np.where(inlier, 1.1, rng.uniform(3, 8, n)),
                      oris0=np.zeros(n),
                      oris1=np.where(inlier, 8.6,
                                     rng.uniform(90.0, 270.0, n)))
    oj = jadalam.adalam_filter(k0, k1, m0, sc, (W, H), (W, H), **kw)
    ot = tadalam.adalam_filter(k0, k1, m0, sc, (W, H), (W, H), **kw)
    _same(oj, ot)
    if case != "outliers_only":
        assert (ot[inlier] >= 0).mean() > 0.7


def test_adalam_match_takes_the_ports_features():
    """adalam_match fed the port's Features (tensors, with SIFT-style
    scales and orientations) equals JAX's on the same numpy values."""
    rng = np.random.default_rng(1)
    k0, k1, m0, _, _ = _synthetic(rng, n_in=60, n_out=20)
    d = rng.standard_normal((len(m0), 32))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d1 = d + 0.05 * rng.standard_normal(d.shape)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    extra = [(np.ones(len(m0)), rng.uniform(-0.1, 0.1, len(m0))),
             (np.full(len(m0), 1.1), rng.uniform(0.05, 0.25, len(m0)))]
    fj, ft = [], []
    for kp, de, (s, o) in ((k0, d, extra[0]), (k1, d1, extra[1])):
        arrs = (kp, np.ones(len(m0)), de, s, o)
        fj.append(JFeatures(*arrs))
        ft.append(TFeatures(*(torch.tensor(a) for a in arrs)))
    rj = jadalam.adalam_match(*fj, (W, H), (W, H))
    rt = tadalam.adalam_match(*ft, (W, H), (W, H))
    _same(tuple(rj), tuple(rt))
    assert (rt.matches0 >= 0).sum() > 30


def _dense_pairs(rng, n_pts=60, n_cams=4):
    """``tests/test_match_dense.py``'s dense e2e scene: every pair of 4
    cameras sees every point with sub-pixel noise."""
    pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(4, 6, n_pts)], 1)
    K = np.array([[277.0, 0, 160], [0, 277.0, 120], [0, 0, 1]])
    uvs = [_project(pts, np.eye(3), np.array([0.3 * i - 0.45, 0, 0]), K)
           for i in range(n_cams)]
    dense = {}
    for a in range(n_cams - 1):
        for b in range(a + 1, n_cams):
            noise = rng.normal(0, 0.2, uvs[a].shape)
            dense[(a, b)] = (uvs[a] + noise, uvs[b] + noise,
                             rng.uniform(0.5, 1.0, n_pts))
    return dense, uvs


@pytest.mark.parametrize("kw", [
    dict(max_error=1.0, cell_size=1.0),
    dict(max_error=2.0, cell_size=8.0),
    dict(max_error=1.0, cell_size=1.0, max_kps=40),
    dict(max_error=1.0, cell_size=1.0, fixed=True)],
    ids=["fine", "coarse", "max_kps", "fixed"])
def test_match_dense_equals_jax(kw):
    kw = dict(kw)
    dense, uvs = _dense_pairs(np.random.default_rng(0))
    if kw.pop("fixed", False):
        kw["fixed_keypoints"] = {0: uvs[0][::2].astype(np.float32)}
    kj, sj, mj = jdense.aggregate_dense_matches(dense, **kw)
    kt, st, mt = tdense.aggregate_dense_matches(dense, **kw)
    _same((kj, sj, mj), (kt, st, mt))
    m, s = mt[(0, 1)]
    _same(jdense.matches_to_matches0(m, s, len(kt[0])),
          tdense.matches_to_matches0(m, s, len(kt[0])))
    k = np.array([[0.1, 0.2], [3.9, 4.2], [4.4, 4.6]])
    _same(jdense.quantize(k, 4.0), tdense.quantize(k, 4.0))
    _same(jdense.unique_matches(np.array([0, 1, 2]), np.array([5, 5, 6]),
                                np.array([0.9, 0.4, 0.7])),
          tdense.unique_matches(np.array([0, 1, 2]), np.array([5, 5, 6]),
                                np.array([0.9, 0.4, 0.7])))
