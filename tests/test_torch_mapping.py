"""Port map training against the JAX package on the same seeded inputs:
SSIM and the losses, k-NN scales, ``from_pcd`` / ``grown``, densification
with injected split samples, the opacity reset, and ``train_step`` from a
training state carried over from JAX.

The JAX side trains on its CPU default (``backend="jnp"``: the legacy
per-tile id matrix and its plain blend); the port trains on the same
``bin_gaussians`` lists through the plain versions of K3/K4. One train
step is also held on the stream layout, the scene runner's default: JAX's
Pallas stream kernels in interpret mode with the slot-order reduction
against the port's plain K1/K2 with the gather's adjoint.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.core.gaussians import GaussianParams as JGaussians
from gs_localization_tpu.mapping import densify as jdens
from gs_localization_tpu.mapping import losses as jlosses
from gs_localization_tpu.mapping import train as jtrain
from gs_localization_tpu.ops.knn import mean_knn_sq_dist as j_knn
from gs_localization_tpu.ops.ssim import ssim as j_ssim
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_torch.core.gaussians import FIELDS
from gs_localization_torch.core.gaussians import GaussianParams
from gs_localization_torch.mapping import densify as tdens
from gs_localization_torch.mapping import losses as tlosses
from gs_localization_torch.mapping import train as ttrain
from gs_localization_torch.ops.knn import mean_knn_sq_dist
from gs_localization_torch.ops.ssim import ssim
from gs_localization_torch.raster import RasterizerConfig
from helpers import make_camera, random_scene
from torch_bridge import (camera_to_torch, gaussians_to_torch, np_of,
                          train_state_to_numpy)

J_CFG = JConfig(max_pairs=1 << 12, max_per_tile=128, chunk=32, backend="jnp",
                use_stream=False)
CFG = RasterizerConfig(max_pairs=1 << 12, max_per_tile=128, pallas_chunk=32,
                       use_stream=False)
# the stream layout (K1/K2): JAX's Pallas kernels in interpret mode
J_STREAM = JConfig(max_pairs=1 << 12, max_render=1 << 12, pallas_chunk=32,
                   backend="pallas_interpret", use_stream=True)
STREAM = RasterizerConfig(max_pairs=1 << 12, max_render=1 << 12,
                          pallas_chunk=32, use_stream=True)
TRAINABLE = ttrain.TRAINABLE


def _t(a):
    return torch.tensor(np.asarray(a))


# ---- SSIM, losses ------------------------------------------------------------

def test_ssim_and_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    d = rng.uniform(0.5, 4, (32, 48)).astype(np.float32)
    gd = np.where(rng.random((32, 48)) < 0.2, 0,
                  d + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
    pd = rng.uniform(1, 50, (32, 48)).astype(np.float32)
    # blur by banded matrix products vs two depthwise convolutions
    np.testing.assert_allclose(float(ssim(_t(a), _t(b))),
                               float(j_ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    for name in ("l1_loss", "l2_loss", "psnr", "pearson_corrcoef",
                 "pearson_depth_loss"):
        x, y = (a, b) if name in ("l1_loss", "l2_loss", "psnr") else (pd, d)
        np.testing.assert_allclose(
            float(getattr(tlosses, name)(_t(x), _t(y))),
            float(getattr(jlosses, name)(jnp.asarray(x), jnp.asarray(y))),
            rtol=1e-5, err_msg=name)
    lt, at = tlosses.training_loss(_t(a), _t(b), _t(d), _t(gd), _t(pd))
    lj, aj = jlosses.training_loss(*map(jnp.asarray, (a, b, d, gd, pd)))
    assert sorted(at) == sorted(aj)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in aj:
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5,
                                   err_msg=k)


# ---- k-NN, from_pcd, grown -----------------------------------------------------

@pytest.mark.parametrize("n", [100, 3])
def test_knn_matches_jax(n):
    """n = 3: fewer real neighbours than k, so the 1e8 padding points are
    candidates, on both sides."""
    pts = np.random.default_rng(n).uniform(-1, 1, (n, 3)).astype(np.float32)
    got = np_of(mean_knn_sq_dist(_t(pts), k=3))
    want = np.asarray(j_knn(jnp.asarray(pts), k=3))
    # |q|^2 + |p|^2 - 2 q.p loses ~|q|^2 * 1e-7 to cancellation
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if n == 3:
        assert (got > 1e15).all()


def test_from_pcd_grown_and_sh_bump_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    gj = JGaussians.from_pcd(pts, cols, sh_degree=1, capacity=96)
    gt = GaussianParams.from_pcd(pts, cols, sh_degree=1, capacity=96,
                                 device="cpu")
    assert (gt.sh_degree, gt.max_sh_degree) == (gj.sh_degree, 1) == (0, 1)
    for pair in ((gt, gj), (gt.grown(128), gj.grown(128))):
        t, j = pair
        assert t.capacity == j.capacity
        for f in FIELDS:
            np.testing.assert_allclose(np_of(getattr(t, f)),
                                       np.asarray(getattr(j, f)), rtol=1e-6,
                                       atol=1e-6, err_msg=f)
    up = gt.one_up_sh_degree()
    assert up.sh_degree == 1 and up.one_up_sh_degree().sh_degree == 1
    with pytest.raises(ValueError, match="0 points"):
        GaussianParams.from_pcd(np.zeros((0, 3)), np.zeros((0, 3)),
                                device="cpu")


# ---- densification -------------------------------------------------------------

def _moments(state):
    return {k: v for k, v in train_state_to_numpy(state).items()
            if k.split("/")[0] in ("mu", "nu", "count")}


def _torch_opt(arrays):
    return {n: ttrain.AdamMoments(_t(arrays[f"mu/{n}"]),
                                  _t(arrays[f"nu/{n}"]),
                                  torch.tensor(int(arrays[f"count/{n}"]),
                                               dtype=torch.int32))
            for n in TRAINABLE}


@pytest.mark.parametrize("case", ["clone_split_prune", "screen_prune",
                                  "drop"])
def test_densify_matches_jax(case):
    rng = np.random.default_rng(2)
    n, cap = (40, 64) if case != "drop" else (60, 64)
    g = random_scene(rng, n=n, sh_degree=1, capacity=cap)
    opa = np.asarray(g.opacity).copy()
    opa[:4] = -8.0                            # below min_opacity: pruned
    g = g.replace(opacity=jnp.asarray(opa))
    state = jtrain.init_training(g, jtrain.MapTrainConfig())
    # non-zero moments, so that zeroing rows shows
    opt = jax.tree_util.tree_map(
        lambda x: x + 0.5 if x.ndim else x, state.opt_state)
    dstate = jdens.DensifyState(
        grad_accum=jnp.asarray(rng.uniform(0, 3e-3, cap), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 4, cap), jnp.float32),
        max_radii=jnp.asarray(rng.uniform(0, 30, cap), jnp.float32))
    kw = dict(grad_threshold=4e-4, min_opacity=0.005, extent=8.0,
              percent_dense=0.01)
    if case == "screen_prune":
        kw.update(max_screen_size=20.0, extent=0.6)
    key = jax.random.PRNGKey(7)
    g2, d2, opt2, rep = jdens.densify_and_prune(g, dstate, opt, key, **kw)
    # the JAX package's split samples, handed to the port
    keys = jax.random.split(key, 2)
    samples = np.stack([np.asarray(jax.random.normal(k, (cap, 3)))
                        for k in keys])
    opt_np = _moments(state.replace(opt_state=opt))
    tg2, td2, topt2, trep = tdens.densify_and_prune(
        gaussians_to_torch(g),
        tdens.DensifyState(*(_t(getattr(dstate, f)) for f in
                             ("grad_accum", "denom", "max_radii"))),
        _torch_opt(opt_np), samples=_t(samples), **kw)
    for f in rep._fields:
        assert int(getattr(trep, f)) == int(getattr(rep, f)), f
    if case == "clone_split_prune":
        assert int(rep.num_cloned) and int(rep.num_split) and \
            int(rep.num_pruned)
    if case == "drop":
        assert int(rep.dropped) > 0
    for f in FIELDS:
        np.testing.assert_allclose(np_of(getattr(tg2, f)),
                                   np.asarray(getattr(g2, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    want = _moments(state.replace(opt_state=opt2))
    for n in TRAINABLE:
        np.testing.assert_array_equal(np_of(topt2[n].mu), want[f"mu/{n}"])
        np.testing.assert_array_equal(np_of(topt2[n].nu), want[f"nu/{n}"])
        assert int(topt2[n].count) == int(want[f"count/{n}"])
    for f in ("grad_accum", "denom", "max_radii"):
        assert (np_of(getattr(td2, f)) == 0).all()


def test_reset_opacity_matches_jax():
    g = random_scene(np.random.default_rng(3), n=30, sh_degree=1,
                     capacity=32)
    state = jtrain.init_training(g, jtrain.MapTrainConfig())
    gj, optj = jdens.reset_opacity(g, state.opt_state)
    opt = _torch_opt(_moments(state))
    gt, optt = tdens.reset_opacity(gaussians_to_torch(g), opt)
    np.testing.assert_allclose(np_of(gt.opacity), np.asarray(gj.opacity),
                               rtol=1e-6, atol=1e-6)
    assert float(gt.get_opacity[gt.live].max()) <= 0.0101
    assert optt is opt       # the moments stay as they were, as in JAX


# ---- train_step ------------------------------------------------------------------

@pytest.fixture(scope="module")
def training():
    """A JAX training state two steps in, its camera and target."""
    target = random_scene(np.random.default_rng(4), n=80, sh_degree=1)
    cam = make_camera(48, 32)
    gt = jax.jit(lambda g: j_rasterize(g, cam, J_CFG).color)(target)
    g = random_scene(np.random.default_rng(5), n=60, sh_degree=1,
                     capacity=64)
    mcfg = jtrain.MapTrainConfig(spatial_scale=2.0)
    state = jtrain.init_training(g, mcfg)
    for _ in range(2):
        state, _ = jtrain.train_step(state, cam, gt, mcfg, J_CFG)
    tcfg = ttrain.MapTrainConfig(spatial_scale=2.0)
    return dict(state=state, cam=cam, gt=gt, mcfg=mcfg, tcfg=tcfg)


def _carry(state):
    return ttrain.MapTrainState.from_numpy(
        train_state_to_numpy(state), state.gaussians.sh_degree,
        state.gaussians.max_sh_degree, device="cpu")


def _grads(m1, m0):
    """Each group's gradient out of its first moment's update."""
    return {n: (m1[f"mu/{n}"].astype(np.float64)
                - 0.9 * m0[f"mu/{n}"]) / 0.1 for n in TRAINABLE}


@pytest.mark.parametrize("use_stream", [False, True])
def test_train_step_one_step_matches_jax(training, use_stream):
    js, cam = training["state"], training["cam"]
    ts = _carry(js)
    assert ts.step == 2 and int(ts.opt_state["xyz"].count) == 2
    j_cfg, t_cfg = (J_STREAM, STREAM) if use_stream else (J_CFG, CFG)
    js1, aj = jtrain.train_step(js, cam, training["gt"], training["mcfg"],
                                j_cfg)
    ts1, at = ttrain.train_step(ts, camera_to_torch(cam),
                                _t(training["gt"]), training["tcfg"], t_cfg)
    np.testing.assert_allclose(float(at["total"]), float(aj["total"]),
                               rtol=1e-5)
    for k in ("num_rendered", "overflow", "tile_overflow", "max_tile_count"):
        assert int(at[k]) == int(aj[k]), k
    m0 = train_state_to_numpy(js)
    mj, mt = train_state_to_numpy(js1), _state_numpy(ts1)
    gj, gt = _grads(mj, m0), _grads(mt, m0)
    # gradients before Adam: the JAX suite's Gaussian-gradient tolerance,
    # relative to each field's largest gradient
    for n in TRAINABLE:
        scale = max(np.abs(gj[n]).max(), 1e-30)
        np.testing.assert_allclose(gt[n] / scale, gj[n] / scale, atol=5e-3,
                                   rtol=1e-2, err_msg=n)
        assert int(mt[f"count/{n}"]) == int(mj[f"count/{n}"]) == 3
    # after Adam (eps 1e-15), a gradient near 0 moves its parameter by ~lr
    # whatever its size, so where the two signs may differ (|g| below
    # 1e-3 of the field's largest gradient) parameters are only counted
    n_small, n_all = 0, 0
    for n in TRAINABLE:
        big = np.abs(gj[n]) > 1e-3 * max(np.abs(gj[n]).max(), 1e-30)
        n_small += int((~big).sum())
        n_all += big.size
        np.testing.assert_allclose(mt[n][big], mj[n][big], atol=1e-5,
                                   rtol=1e-5, err_msg=n)
    assert n_small < 0.5 * n_all, (n_small, n_all)
    for f in ("denom", "max_radii"):
        np.testing.assert_array_equal(mt[f], mj[f], err_msg=f)
    np.testing.assert_allclose(mt["grad_accum"], mj["grad_accum"],
                               rtol=1e-2, atol=1e-6)


def _state_numpy(ts):
    out = ts.gaussians.to_numpy()
    for n, m in ts.opt_state.items():
        out[f"mu/{n}"], out[f"nu/{n}"] = np_of(m.mu), np_of(m.nu)
        out[f"count/{n}"] = np_of(m.count)
    for f in ("grad_accum", "denom", "max_radii"):
        out[f] = np_of(getattr(ts.densify, f))
    return out


def test_train_step_three_steps_match_jax(training):
    js, cam = training["state"], training["cam"]
    ts = _carry(js)
    tcam, tgt = camera_to_torch(cam), _t(training["gt"])
    lj, lt = [], []
    for _ in range(3):
        js, aj = jtrain.train_step(js, cam, training["gt"], training["mcfg"],
                                   J_CFG)
        ts, at = ttrain.train_step(ts, tcam, tgt, training["tcfg"], CFG)
        lj.append(float(aj["total"]))
        lt.append(float(at["total"]))
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert ts.step == int(js.step) == 5
    mj, mt = train_state_to_numpy(js), _state_numpy(ts)
    # where the first moment is well away from 0 on both sides, the
    # parameters agree; the rest (a gradient sign that rounding can flip
    # moves a parameter by ~lr per step) are counted
    n_small = 0
    for n in TRAINABLE:
        big = np.abs(mj[f"mu/{n}"]) > 1e-2 * np.abs(mj[f"mu/{n}"]).max()
        n_small += int((~big).sum())
        np.testing.assert_allclose(mt[n][big], mj[n][big], atol=1e-4,
                                   rtol=1e-4, err_msg=n)
        np.testing.assert_allclose(mt[f"nu/{n}"], mj[f"nu/{n}"],
                                   atol=1e-3 * mj[f"nu/{n}"].max() + 1e-30,
                                   rtol=1e-2, err_msg=n)
    assert n_small < 0.6 * sum(mj[n].size for n in TRAINABLE)


def test_grow_capacity_matches_jax(training):
    js = training["state"]
    grown_j = jtrain.grow_capacity(js, 96)
    grown_t = ttrain.grow_capacity(_carry(js), 96)
    want, got = train_state_to_numpy(grown_j), _state_numpy(grown_t)
    assert grown_t.gaussians.capacity == 96
    for k, v in want.items():
        if k != "step":
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError, match="new capacity"):
        ttrain.grow_capacity(grown_t, 96)


def test_random_background_follows_the_seed(training):
    cam, gt = camera_to_torch(training["cam"]), _t(training["gt"])
    g = _carry(training["state"]).gaussians
    cfg = ttrain.MapTrainConfig(random_background=True)
    totals = []
    for seed in (1, 1, 2):
        state = ttrain.init_training(g, cfg, seed=seed)
        _, aux = ttrain.train_step(state, cam, gt, cfg, CFG)
        totals.append(float(aux["total"]))
    assert totals[0] == totals[1] != totals[2]
