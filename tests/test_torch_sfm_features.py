"""The port's SfM features, matching and retrieval against the JAX package's.

Harris keypoints, scores and descriptors, the tiny-image descriptor,
mutual-NN matching fed the same descriptors, top-k retrieval (with tied
scores) and DoG/rootSIFT, on the same images made from a seed. The JAX side
runs jitted, as its own tests run it; the port runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.raster import RasterizerConfig, rasterize
from gs_localization_tpu.sfm import features as jfeat
from gs_localization_tpu.sfm import matching as jmatch
from gs_localization_tpu.sfm import retrieval as jret
from gs_localization_tpu.sfm import sift as jsift
from gs_localization_torch.sfm import features as tfeat
from gs_localization_torch.sfm import matching as tmatch
from gs_localization_torch.sfm import retrieval as tret
from gs_localization_torch.sfm import sift as tsift
from helpers import make_camera, random_scene
from test_sfm import _checkerboard
from test_sift import _textured_image


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
def render():
    """A 160x120 JAX render of many small opaque Gaussians (the SfM-init
    test's world), colour in [0, 1]."""
    rng = np.random.default_rng(21)
    g = random_scene(rng, n=900, sh_degree=1, spread=1.6,
                     z_range=(3.0, 6.0), scale_range=(-4.2, -3.2))
    cfg = RasterizerConfig(max_pairs=1 << 15, max_per_tile=256, chunk=32,
                           backend="jnp")
    cam = make_camera(160, 120, fov=1.0)
    return np.asarray(jax.jit(lambda g: rasterize(g, cam, cfg).color)(g))


def _images(render):
    return {
        "checkerboard": _checkerboard(np.random.default_rng(0)),
        "render": np.asarray(jfeat.rgb_to_gray(jnp.asarray(render))),
        "noise": np.random.default_rng(3).uniform(
            0, 1, (120, 160)).astype(np.float32),
    }


def _response64(img: np.ndarray) -> np.ndarray:
    """The Harris response map in float64, to tell tied responses apart."""
    x = torch.tensor(img, dtype=torch.float64)
    smooth = tfeat._sep_conv(x, tfeat._gauss_kernel(1.0, 2))
    dx = (torch.roll(smooth, -1, 1) - torch.roll(smooth, 1, 1)) * 0.5
    dy = (torch.roll(smooth, -1, 0) - torch.roll(smooth, 1, 0)) * 0.5
    g = tfeat._gauss_kernel(1.5, 3)
    ixx, iyy, ixy = (tfeat._sep_conv(a, g) for a in (dx * dx, dy * dy,
                                                      dx * dy))
    tr = ixx + iyy
    return (ixx * iyy - ixy * ixy - 0.04 * tr * tr).numpy()


def _tied(resp: np.ndarray, xy, radius: int = 4, rtol: float = 1e-5):
    """Whether another pixel in the NMS window of xy has the same response
    within rtol: which of the two survives NMS is decided by rounding."""
    x, y = int(xy[0]), int(xy[1])
    win = resp[max(y - radius, 0):y + radius + 1,
               max(x - radius, 0):x + radius + 1]
    close = np.abs(win - resp[y, x]) <= rtol * abs(resp[y, x])
    return int(close.sum()) > 1


@pytest.mark.parametrize("name", ["checkerboard", "render", "noise"])
def test_harris_matches_jax(render, name):
    img = _images(render)[name]
    fj = jfeat.extract_harris_features(jnp.asarray(img), num_keypoints=256)
    ft = tfeat.extract_harris_features(torch.tensor(img), num_keypoints=256)
    kj, sj, dj = (np.asarray(a) for a in fj[:3])
    kt, st, dt = (a.numpy() for a in ft[:3])
    vj, vt = sj > 0, st > 0
    assert vj.sum() > 30
    if name == "checkerboard":
        # the 6x6 blocks' corners have exactly equal responses, so which of
        # two tied corners survives NMS follows the convolution's rounding
        # (XLA's summation order and the port's differ): every keypoint of
        # one package that the other lacks is tied with a neighbour, and
        # the shared ones agree
        resp = _response64(img)
        pj = {tuple(p): i for i, p in enumerate(kj[vj])}
        pt = {tuple(p): i for i, p in enumerate(kt[vt])}
        print(f"checkerboard: {vj.sum()} keypoints JAX, {vt.sum()} port, "
              f"{np.mean(np.all(kj == kt, axis=1)[vj]):.4f} of the JAX "
              f"slots equal, {len(set(pj) ^ set(pt))} tied keypoints in "
              f"one package only")
        for p in set(pj) ^ set(pt):
            assert _tied(resp, p), p
        common = sorted(set(pj) & set(pt))
        assert len(common) >= 0.8 * vj.sum()
        a = np.array([pj[p] for p in common])
        b = np.array([pt[p] for p in common])
        np.testing.assert_allclose(st[vt][b], sj[vj][a], rtol=1e-5)
        np.testing.assert_allclose(dt[vt][b], dj[vj][a], atol=1e-5)
        return
    same = np.all(kj == kt, axis=1)
    assert same[vj].mean() >= 0.99, same[vj].mean()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(st[same], sj[same], rtol=1e-5)
    np.testing.assert_allclose(dt[same], dj[same], atol=1e-5)


def test_tiny_descriptor_and_matching_match_jax(render):
    rgb = render
    noisy = np.clip(rgb + 0.02 * np.random.default_rng(5).standard_normal(
        rgb.shape), 0, 1).astype(np.float32)
    for im in (rgb, noisy):
        gj = np.asarray(jax.jit(jfeat.tiny_image_descriptor)(jnp.asarray(im)))
        gt = tfeat.tiny_image_descriptor(torch.tensor(im)).numpy()
        np.testing.assert_allclose(gt, gj, atol=1e-6)
    # matching fed the same descriptors: the JAX Harris features of the
    # render and of its noisy copy
    f0 = jfeat.extract_harris_features(jfeat.rgb_to_gray(jnp.asarray(rgb)),
                                       num_keypoints=256)
    f1 = jfeat.extract_harris_features(
        jfeat.rgb_to_gray(jnp.asarray(noisy)), num_keypoints=256)
    for ratio in (0.8, 0.95):
        mj = jmatch.match_mutual_nn(f0.descriptors, f1.descriptors,
                                    f0.scores > 0, f1.scores > 0,
                                    ratio_thresh=ratio)
        t = [torch.tensor(np.asarray(a)) for a in
             (f0.descriptors, f1.descriptors, f0.scores > 0, f1.scores > 0)]
        mt = tmatch.match_mutual_nn(*t, ratio_thresh=ratio)
        np.testing.assert_array_equal(mt.matches0.numpy(),
                                      np.asarray(mj.matches0))
        np.testing.assert_allclose(mt.scores.numpy(), np.asarray(mj.scores),
                                   atol=1e-6)
        assert (mt.matches0.numpy() >= 0).sum() > 20


@pytest.mark.parametrize("case", ["plain", "self_masked", "tied"])
def test_top_k_retrieval_matches_jax(case):
    rng = np.random.default_rng(11)
    db = rng.standard_normal((20, 64)).astype(np.float32)
    q = db[[3, 7, 12]] + 0.3 * rng.standard_normal((3, 64)).astype(
        np.float32)
    kw = {}
    if case == "self_masked":
        q = db
        names = [f"i{i}" for i in range(20)]
        kw = dict(query_names=names, db_names=names)
    elif case == "tied":
        # exact duplicates in the database (and a query that equals one):
        # equal scores come lowest index first
        db[[5, 9, 15]] = db[2]
        db[[4, 8]] = 2.0 * db[1]
        q = np.concatenate([q, db[[2, 1]]])
    ij, sj = jret.top_k_retrieval(q, db, k=6, **kw)
    it, st = tret.top_k_retrieval(q, db, k=6, device="cpu", **kw)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-6)
    if case == "tied":
        assert it[3, :4].tolist() == [2, 5, 9, 15]
        assert it[4, :3].tolist() == [1, 4, 8]


def test_sift_matches_jax():
    img = _textured_image(np.random.default_rng(0))
    fj = jsift.extract_sift(jnp.asarray(img), num_keypoints=128)
    ft = tsift.extract_sift(torch.tensor(img), num_keypoints=128)
    vj = np.asarray(fj.scores) > 0
    np.testing.assert_array_equal(ft.scores.numpy() > 0, vj)
    assert vj.sum() >= 20
    pos = np.abs(ft.keypoints.numpy() - np.asarray(fj.keypoints)).max(1) \
        <= 1e-3
    desc = np.abs(ft.descriptors.numpy() - np.asarray(fj.descriptors)
                  ).max(1) <= 1e-4
    ori = ft.orientations.numpy() == np.asarray(fj.orientations)
    share = (pos & desc & ori)[vj].mean()
    assert share >= 0.95, (pos[vj].mean(), desc[vj].mean(), ori[vj].mean())
    np.testing.assert_allclose(ft.scales.numpy(), np.asarray(fj.scales),
                               rtol=1e-6)
    np.testing.assert_allclose(ft.scores.numpy(), np.asarray(fj.scores),
                               rtol=1e-5)
