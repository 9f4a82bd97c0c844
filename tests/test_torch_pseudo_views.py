"""Few-shot map training in the port against the JAX package: the pseudo
poses, ``train_step``'s pseudo-view term, ``train_step_batched``, and
``train_map``'s pseudo-view schedule.

The JAX side renders with ``backend="jnp"`` under ``jax.jit``; the port
with the plain versions of K3/K4 on the same ``bin_gaussians`` lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_localization_tpu.mapping import train as jtrain
from gs_localization_tpu.mapping.pseudo_views import (
    generate_pseudo_poses as j_generate_pseudo_poses)
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_torch.data.scene import CameraInfo, SceneInfo
from gs_localization_torch.mapping import train as ttrain
from gs_localization_torch.mapping.pseudo_views import generate_pseudo_poses
from gs_localization_torch.pipelines import train_map as ttm
from gs_localization_torch.raster import RasterizerConfig
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, np_of, train_state_to_numpy

J_CFG = JConfig(max_pairs=1 << 12, max_per_tile=128, chunk=32, backend="jnp",
                use_stream=False)
CFG = RasterizerConfig(max_pairs=1 << 12, max_per_tile=128, pallas_chunk=32,
                       use_stream=False)
TRAINABLE = ttrain.TRAINABLE


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: its loops run many small CPU
    ops, and when each spreads over a thread pool, the suite's parallel
    workers (more threads than cores) make every op wait on a barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tour(n, seed):
    """n cameras moved by up to 0.3 rad and 0.5 m from the origin camera."""
    rng = np.random.default_rng(seed)
    base = make_camera(48, 32)
    return [base.with_delta(jnp.asarray(
        np.concatenate([rng.uniform(-0.5, 0.5, 3),
                        rng.uniform(-0.3, 0.3, 3)]), jnp.float32))
            for _ in range(n)]


@pytest.mark.parametrize("n,per_edge", [(2, 1), (5, 3), (8, 3)])
def test_pseudo_poses_match_jax(n, per_edge):
    cams = _tour(n, seed=n)
    pj = j_generate_pseudo_poses(cams, n_per_edge=per_edge)
    pt = generate_pseudo_poses([camera_to_torch(c) for c in cams],
                               n_per_edge=per_edge)
    assert len(pt) == len(pj) == (n - 1) * per_edge
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(np_of(a.w2c), np.asarray(b.w2c),
                                   atol=1e-6)
        for f in ("fx", "fy", "cx", "cy"):
            assert float(getattr(a, f)) == float(getattr(b, f))
        assert (a.width, a.height) == (b.width, b.height)
    assert generate_pseudo_poses([camera_to_torch(cams[0])]) == []


# ---- train_step with a pseudo view, train_step_batched ---------------------

def _t(a):
    return torch.tensor(np.asarray(a))


def _carry(state):
    return ttrain.MapTrainState.from_numpy(
        train_state_to_numpy(state), state.gaussians.sh_degree,
        state.gaussians.max_sh_degree, device="cpu")


def _state_numpy(ts):
    out = ts.gaussians.to_numpy()
    for n, m in ts.opt_state.items():
        out[f"mu/{n}"], out[f"nu/{n}"] = np_of(m.mu), np_of(m.nu)
        out[f"count/{n}"] = np_of(m.count)
    for f in ("grad_accum", "denom", "max_radii"):
        out[f] = np_of(getattr(ts.densify, f))
    return out


def _hold_grads(js0, js1, ts1):
    """Each group's gradient (out of its first moment's update) within the
    JAX suite's Gaussian-gradient tolerance of JAX's, relative to the
    field's largest gradient; the densify statistics alike."""
    m0, mj, mt = train_state_to_numpy(js0), train_state_to_numpy(js1), \
        _state_numpy(ts1)
    for n in TRAINABLE:
        gj = (mj[f"mu/{n}"].astype(np.float64) - 0.9 * m0[f"mu/{n}"]) / 0.1
        gt = (mt[f"mu/{n}"].astype(np.float64) - 0.9 * m0[f"mu/{n}"]) / 0.1
        scale = max(np.abs(gj).max(), 1e-30)
        np.testing.assert_allclose(gt / scale, gj / scale, atol=5e-3,
                                   rtol=1e-2, err_msg=n)
        assert int(mt[f"count/{n}"]) == int(mj[f"count/{n}"])
    for f in ("denom", "max_radii"):
        np.testing.assert_array_equal(mt[f], mj[f], err_msg=f)
    np.testing.assert_allclose(mt["grad_accum"], mj["grad_accum"],
                               rtol=1e-2, atol=1e-6)


@pytest.fixture(scope="module")
def training():
    """A JAX training state two steps in, a target and a pseudo camera
    with its depth prior."""
    target = random_scene(np.random.default_rng(4), n=80, sh_degree=1)
    cam = make_camera(48, 32)
    render = jax.jit(lambda g, c: j_rasterize(g, c, J_CFG))
    gt = render(target, cam).color
    g = random_scene(np.random.default_rng(5), n=60, sh_degree=1,
                     capacity=64)
    mcfg = jtrain.MapTrainConfig(spatial_scale=2.0)
    state = jtrain.init_training(g, mcfg)
    for _ in range(2):
        state, _ = jtrain.train_step(state, cam, gt, mcfg, J_CFG)
    pcam = cam.with_delta(jnp.asarray([0.05, -0.03, 0.02, 0.02, 0.01, -0.02],
                                      jnp.float32))
    # a depth prior: the target's depth, warped monotonically
    pdepth = 1.0 / (0.2 + render(target, pcam).depth)
    return dict(state=state, cam=cam, gt=gt, pcam=pcam, pdepth=pdepth,
                mcfg=mcfg, tcfg=ttrain.MapTrainConfig(spatial_scale=2.0))


def test_train_step_pseudo_term_matches_jax(training):
    js, cam = training["state"], training["cam"]
    assert ttrain.MapTrainConfig().lambda_pseudo_view == \
        jtrain.MapTrainConfig().lambda_pseudo_view == 0.005
    js1, aj = jtrain.train_step(
        js, cam, training["gt"], training["mcfg"], J_CFG,
        pseudo_camera=training["pcam"],
        pseudo_view_depth=training["pdepth"])
    ts1, at = ttrain.train_step(
        _carry(js), camera_to_torch(cam), _t(training["gt"]),
        training["tcfg"], CFG, pseudo_camera=camera_to_torch(
            training["pcam"]), pseudo_view_depth=_t(training["pdepth"]))
    assert sorted(at) == sorted(aj)
    assert 0.0 < float(aj["pseudo_view"]) < 2.0
    for k in ("pseudo_view", "total", "l1"):
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5,
                                   err_msg=k)
    _hold_grads(js, js1, ts1)
    # the term moves the step: without it the gradients differ
    js_plain, _ = jtrain.train_step(js, cam, training["gt"],
                                    training["mcfg"], J_CFG)
    assert not np.allclose(np.asarray(js_plain.opt_state.inner_states[
        "xyz"].inner_state[0].mu["xyz"]), np.asarray(js1.opt_state.
        inner_states["xyz"].inner_state[0].mu["xyz"]), atol=1e-9)


def test_train_step_batched_matches_jax(training):
    """B = 4 views as in the JAX suite's ``TestBatchedTrain``."""
    rng = np.random.default_rng(0)
    js = training["state"]
    base = make_camera(48, 32)
    taus = jnp.asarray(0.02 * rng.standard_normal((4, 6)), jnp.float32)
    cams = jax.vmap(base.with_delta)(taus)
    gts = jnp.asarray(rng.uniform(0, 1, (4, 32, 48, 3)), jnp.float32)
    deps = jnp.asarray(rng.uniform(1, 5, (4, 32, 48)), jnp.float32)
    tcams = [camera_to_torch(jax.tree_util.tree_map(lambda x: x[b], cams))
             for b in range(4)]
    for gt_depths in (None, deps):
        js1, aj = jtrain.train_step_batched(js, cams, gts, training["mcfg"],
                                            J_CFG, gt_depths=gt_depths)
        ts0 = _carry(js)
        gen_state = ts0.generator.get_state()
        ts1, at = ttrain.train_step_batched(
            ts0, tcams, _t(gts), training["tcfg"], CFG,
            gt_depths=None if gt_depths is None else _t(gt_depths))
        assert sorted(at) == sorted(aj)
        for k in ("total", "l1"):
            np.testing.assert_allclose(float(at[k]), float(aj[k]),
                                       rtol=1e-5, err_msg=k)
        for k in ("overflow", "tile_overflow", "max_tile_count"):
            assert int(at[k]) == int(aj[k]), k
        assert ts1.step == int(js1.step) == 3
        assert torch.equal(ts1.generator.get_state(), gen_state)
        _hold_grads(js, js1, ts1)


# ---- train_map's pseudo-view schedule -----------------------------------------

PIPE = dict(iterations=24, sh_degree=1, capacity_multiplier=1.5,
            densify_from=10_000, densify_until=0,
            opacity_reset_interval=10_000, sh_up_interval=1_000,
            test_iterations=(), save_iterations=(), log_every=1000,
            fewshot_threshold=200, sample_pseudo_interval=4,
            start_sample_pseudo=3, end_sample_pseudo=21, pseudo_per_edge=2,
            seed=6)


def _replay(n_cams, n_pseudo, p):
    """JAX train_map's rng draws, replayed in numpy: the training camera
    every iteration, then on a pseudo iteration the pseudo camera."""
    rng = np.random.default_rng(p["seed"])
    seq = []
    for it in range(1, p["iterations"] + 1):
        cam = int(rng.integers(n_cams))
        pseudo = None
        if (it % p["sample_pseudo_interval"] == 0
                and p["start_sample_pseudo"] < it < p["end_sample_pseudo"]):
            pseudo = int(rng.integers(n_pseudo))
        seq.append((cam, pseudo))
    return seq


def test_train_map_draws_pseudo_views_as_jax(monkeypatch):
    target = random_scene(np.random.default_rng(8), n=60, sh_degree=1)
    cams = _tour(4, seed=9)
    render = jax.jit(lambda c: j_rasterize(target, c, J_CFG).color)
    imgs = [np.asarray(render(c)) for c in cams]
    tcams = [camera_to_torch(c) for c in cams]
    infos = [CameraInfo(uid=i, name=f"c{i}", camera=c)
             for i, c in enumerate(tcams)]
    pts = np.asarray(target.xyz)[:40]
    scene = SceneInfo(infos, [], pts, np.full((40, 3), 0.5, np.float32),
                      extent=2.0)
    pseudo = generate_pseudo_poses(tcams, n_per_edge=PIPE["pseudo_per_edge"])
    seen, depths = [], []
    real_step = ttm.train_step

    def recording_step(state, camera, *a, pseudo_camera=None, **kw):
        cam = [i for i, c in enumerate(tcams) if c is camera]
        pcam = None if pseudo_camera is None else [
            i for i, c in enumerate(pseudo)
            if torch.equal(c.w2c, pseudo_camera.w2c)]
        seen.append((cam[0], None if pcam is None else pcam[0]))
        state, aux = real_step(state, camera, *a,
                               pseudo_camera=pseudo_camera, **kw)
        if pseudo_camera is not None:
            depths.append(float(aux["pseudo_view"]))
        return state, aux

    def fake_depth(rgb):
        assert rgb.shape == (32, 48, 3) and rgb.dtype == np.float32
        return 1.0 / (0.1 + rgb.mean(axis=-1))

    calls = []
    monkeypatch.setattr(ttm, "train_step", recording_step)
    logs = []
    ttm.train_map(scene, None, ttm.TrainPipelineConfig(**PIPE),
                  raster_cfg=CFG,
                  image_loader=lambda info: (imgs[info.uid], None),
                  depth_estimator=lambda rgb: calls.append(1) or
                  fake_depth(rgb), log_fn=logs.append, device="cpu")
    expect = _replay(len(cams), len(pseudo), PIPE)
    n_pseudo_steps = sum(p is not None for _, p in expect)
    assert "few-shot: generated 6 pseudo views" in logs
    assert n_pseudo_steps == 5 and len(calls) == n_pseudo_steps
    assert seen == expect
    assert len(depths) == n_pseudo_steps and np.isfinite(depths).all()
