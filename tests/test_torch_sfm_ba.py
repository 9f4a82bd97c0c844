"""The port's bundle adjustment and incremental mapper against the JAX
package's, on ``tests/test_incremental_sfm.py``'s synthetic scene (cameras
on an arc, noisy pairwise matches with wrong associations), with that
file's own assertions run on the port as well."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.core.se3 import se3_exp
from gs_localization_tpu.sfm.incremental import (
    incremental_mapping as j_incremental)
from gs_localization_torch.sfm.evaluate import umeyama_alignment
from gs_localization_torch.sfm.incremental import (
    decompose_essential, essential_ransac, incremental_mapping)
from test_incremental_sfm import _project, _synthetic_scene

# the modules (each package's ``sfm`` exports a function of the same name)
jba = importlib.import_module("gs_localization_tpu.sfm.bundle_adjust")
tba = importlib.import_module("gs_localization_torch.sfm.bundle_adjust")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: its loops run many small CPU
    ops, and when each spreads over a thread pool, the suite's parallel
    workers (more threads than cores) make every op wait on a barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot_err_deg(Ra, Rb) -> float:
    cos = np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)
    return float(np.degrees(np.arccos(cos)))


@pytest.fixture(scope="module")
def ba_problem():
    """``TestBundleAdjust``'s problem: 5 cameras perturbed by 0.015-rad /
    1.5-cm tangents (the first kept), 150 points moved by 4 cm, every point
    seen by every camera with 0.3 px noise."""
    rng = np.random.default_rng(0)
    X, w2c_gt, K, _, _ = _synthetic_scene(rng, n_cams=5, n_pts=150,
                                          noise_px=0.3)
    n_cams, n_pts = 5, len(X)
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    uv = np.concatenate([_project(w2c_gt[c], X, K)[0]
                         for c in range(n_cams)])
    uv += 0.3 * rng.standard_normal(uv.shape)
    taus = jnp.asarray(0.015 * rng.standard_normal((n_cams, 6)), jnp.float32)
    w2c0 = np.asarray(jax.vmap(se3_exp)(taus)) @ w2c_gt
    w2c0[0] = w2c_gt[0]
    X0 = X + 0.04 * rng.standard_normal(X.shape)
    Ks = np.tile(K[None], (n_cams, 1, 1))
    return w2c_gt, (w2c0, Ks, X0, cam_idx, pt_idx, uv)


def _problems(args):
    """The BA problem of ``args`` in each package's ``BAProblem``."""
    w2c0, Ks, X0, cam_idx, pt_idx, uv = args
    fixed = np.arange(len(w2c0)) == 0
    e = len(cam_idx)
    jprob = jba.BAProblem(
        jnp.asarray(w2c0, jnp.float32), jnp.asarray(Ks, jnp.float32),
        jnp.asarray(X0, jnp.float32), jnp.asarray(cam_idx, jnp.int32),
        jnp.asarray(pt_idx, jnp.int32), jnp.asarray(uv, jnp.float32),
        jnp.ones(e, jnp.float32), jnp.asarray(fixed))

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(dtype)

    tprob = tba.BAProblem(
        t(w2c0, torch.float32), t(Ks, torch.float32), t(X0, torch.float32),
        t(cam_idx, torch.int64), t(pt_idx, torch.int64),
        t(uv, torch.float32), torch.ones(e), t(fixed, torch.bool))
    return jprob, tprob


def test_bundle_adjust_matches_jax(ba_problem):
    """``TestBundleAdjust``'s 20 LM steps (what ``bundle_adjust_np``
    runs), then the default 15 for the count of accepted steps: the CG's
    float32 rounding moves each step's cost a little, and once the cost
    sits at its float32 floor an acceptance compares costs a few ulps
    apart, so the counts of the 20-step runs differ (printed)."""
    w2c_gt, args = ba_problem
    jprob, tprob = _problems(args)
    rj = jba._ba_jitted(20, 40, 4.0, 1e-3)(jprob)
    rt = tba.bundle_adjust(tprob, iters=20)
    wj, wt = np.asarray(rj.w2c), rt.w2c.numpy()
    c0t, ct = float(rt.cost0), float(rt.cost)
    print(f"20 LM steps: cost {float(rj.cost0):.6f} -> {float(rj.cost):.6f}"
          f" ({int(rj.num_iters)} accepted) JAX, {c0t:.6f} -> {ct:.6f} "
          f"({int(rt.num_iters)} accepted) port")
    np.testing.assert_allclose(c0t, float(rj.cost0), rtol=1e-5)
    np.testing.assert_allclose(ct, float(rj.cost), rtol=1e-3)
    np.testing.assert_allclose(wt, wj, atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points),
                               atol=1e-3)
    # the JAX test's own bounds, on the port
    assert ct < 0.02 * c0t
    for c in range(len(w2c_gt)):
        assert _rot_err_deg(wt[c, :3, :3], w2c_gt[c, :3, :3]) < 0.15, c
    # bundle_adjust_np is that solver behind numpy
    w, x, c0, c1 = tba.bundle_adjust_np(*args, iters=2, device="cpu")
    r2 = tba.bundle_adjust(tprob, iters=2)
    np.testing.assert_array_equal(w, r2.w2c.numpy())
    np.testing.assert_array_equal(x, r2.points.numpy())
    assert (c0, c1) == (float(r2.cost0), float(r2.cost))
    # the accepted steps, at the default 15
    jres = jba._ba_jitted(15, 40, 4.0, 1e-3)(jprob)
    tres = tba.bundle_adjust(tprob)
    assert int(tres.num_iters) == int(jres.num_iters) == 15
    np.testing.assert_allclose(float(tres.cost), float(jres.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(tres.w2c.numpy(), np.asarray(jres.w2c),
                               atol=1e-4)


def test_two_view_on_the_port():
    """``TestTwoView``'s bounds on the port's essential RANSAC and its
    decomposition (numpy copies of JAX's)."""
    rng = np.random.default_rng(0)
    X, w2c, K, _, _ = _synthetic_scene(rng, n_cams=2, outlier_frac=0.2)
    uv1, _ = _project(w2c[0], X, K)
    uv2, _ = _project(w2c[1], X, K)
    xy1 = (uv1 - K[:2, 2]) / np.diag(K)[:2]
    xy2 = (uv2 - K[:2, 2]) / np.diag(K)[:2]
    n_out = len(xy1) // 5
    xy2[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    E, inl = essential_ransac(xy1, xy2, seed=1)
    assert inl[n_out:].mean() > 0.95
    assert inl[:n_out].mean() < 0.1
    R, t = decompose_essential(E, xy1[inl], xy2[inl])
    rel = w2c[1] @ np.linalg.inv(w2c[0])
    assert _rot_err_deg(rel[:3, :3].T @ R, np.eye(3)) < 0.5
    t_gt = rel[:3, 3] / np.linalg.norm(rel[:3, 3])
    assert np.dot(t_gt, t / np.linalg.norm(t)) > 0.999


def test_incremental_mapping_matches_jax(capsys):
    rng = np.random.default_rng(0)
    X, w2c_gt, K, kps, matches = _synthetic_scene(
        rng, n_cams=8, n_pts=300, noise_px=0.4, outlier_frac=0.05)
    rj = j_incremental(kps, matches, K, seed=2, verbose=True)
    log_j = capsys.readouterr().out
    rec = incremental_mapping(kps, matches, K, seed=2, verbose=True,
                              device="cpu")
    log_t = capsys.readouterr().out
    assert rec.init_pair == rj.init_pair
    np.testing.assert_array_equal(rec.registered, rj.registered)
    np.testing.assert_array_equal(rec.valid, rj.valid)
    np.testing.assert_allclose(rec.w2c, rj.w2c, atol=1e-4)
    np.testing.assert_allclose(rec.points[rec.valid], rj.points[rj.valid],
                               atol=1e-3)
    # the same registration order, and the final BA costs within 1e-3

    def lines(log, word):
        return [ln for ln in log.splitlines() if word in ln]

    assert lines(log_t, "registered") == lines(log_j, "registered")
    final_j = float(lines(log_j, "BA over")[-1].split("-> ")[1])
    final_t = float(lines(log_t, "BA over")[-1].split("-> ")[1])
    np.testing.assert_allclose(final_t, final_j, rtol=1e-3)

    # TestIncrementalMapping's own bounds, on the port
    assert rec.registered.sum() >= 7, rec.registered
    reg = np.nonzero(rec.registered)[0]
    c_est = np.stack([-rec.w2c[c, :3, :3].T @ rec.w2c[c, :3, 3]
                      for c in reg])
    c_gt = np.stack([-w2c_gt[c, :3, :3].T @ w2c_gt[c, :3, 3] for c in reg])
    s, R, t = umeyama_alignment(c_est, c_gt)
    resid = s * c_est @ R.T + t - c_gt
    scene_scale = np.linalg.norm(c_gt - c_gt.mean(0), axis=1).max()
    assert np.linalg.norm(resid, axis=1).max() < 0.02 * scene_scale
    for c in reg:
        assert _rot_err_deg(rec.w2c[c, :3, :3] @ R.T, w2c_gt[c, :3, :3]) \
            < 1.0, c
    assert rec.valid.sum() > 150
