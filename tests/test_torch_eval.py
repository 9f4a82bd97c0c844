"""Evaluation and checkpoints of the port against the JAX package: LPIPS on
random weights (carried over as numpy, and through the torch-checkpoint
converter), ``render_and_eval``'s PSNR/SSIM, and a training-state
checkpoint round trip."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gs_localization_tpu.data.scene import CameraInfo as JInfo
from gs_localization_tpu.ops import lpips as jl
from gs_localization_tpu.pipelines import render_eval as jre
from gs_localization_tpu.raster import RasterizerConfig as JConfig
from gs_localization_tpu.raster import rasterize as j_rasterize
from gs_localization_torch.data.scene import CameraInfo
from gs_localization_torch.mapping import train as ttrain
from gs_localization_torch.mapping.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
from gs_localization_torch.ops import lpips as tl
from gs_localization_torch.pipelines.render_eval import (
    load_lpips_params, render_and_eval)
from gs_localization_torch.raster import RasterizerConfig
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch

# the JAX suite's LPIPS tolerance (its torch twin, tests/test_lpips.py)
LPIPS_TOL = dict(rel=2e-4, abs=1e-5)


def _images(rng, h=32, w=32):
    x = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    return x, y


def test_lpips_matches_jax_on_random_weights():
    rng = np.random.default_rng(0)
    params = jl.init_params(rng)
    x, y = _images(rng)
    ours = tl.lpips_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                           params),
                                    device="cpu")
    with torch.no_grad():
        got = float(ours(torch.tensor(x), torch.tensor(y)))
        same = float(ours(torch.tensor(x), torch.tensor(x)))
    want = float(jl.lpips(params, jnp.asarray(x), jnp.asarray(y)))
    assert got == pytest.approx(want, **LPIPS_TOL) and got > 0
    assert same == 0.0


def _torch_checkpoints(rng, path):
    """A torchvision-style vgg16 state_dict (full model keys) and a
    richzhang lin state_dict, saved as torch files; returns both dicts."""
    chans = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    sd, cin = {}, 3
    for i, c in zip(tl._CONV_IDX, chans):
        sd[f"features.{i}.weight"] = (rng.standard_normal((c, cin, 3, 3))
                                      * np.sqrt(2.0 / (9 * cin))).astype(
            np.float32)
        sd[f"features.{i}.bias"] = (0.01 * rng.standard_normal(c)).astype(
            np.float32)
        cin = c
    lin = {f"lin{t}.model.1.weight":
           rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32)
           for t, c in enumerate(tl.VGG16_TAP_CHANNELS)}
    torch.save({k: torch.tensor(v) for k, v in sd.items()},
               os.path.join(path, "vgg16.pth"))
    torch.save({k: torch.tensor(v) for k, v in lin.items()},
               os.path.join(path, "vgg.pth"))
    return sd, lin


def test_lpips_converter_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    sd, lin = _torch_checkpoints(rng, str(tmp_path))
    feats = {k[len("features."):]: v for k, v in sd.items()}
    lin_j = {k.replace("lin", "").replace("model.", ""): v
             for k, v in lin.items()}
    params = jl.convert_torch_weights_lpips(feats, lin_j)
    ours = load_lpips_params(str(tmp_path / "vgg16.pth"),
                             str(tmp_path / "vgg.pth"), device="cpu")
    x, y = _images(rng, 35, 41)            # odd sizes through the pools
    with torch.no_grad():
        got = float(ours(torch.tensor(x), torch.tensor(y)))
    want = float(jl.lpips(params, jnp.asarray(x), jnp.asarray(y)))
    assert got == pytest.approx(want, **LPIPS_TOL) and got > 0
    with pytest.raises(KeyError, match="tap 1"):
        tl.convert_torch_weights_lpips(feats, {"0.1.weight": lin_j[
            "0.1.weight"]}, device="cpu")


def test_render_and_eval_matches_jax(tmp_path, monkeypatch):
    # the JAX pipeline's render and metrics, jitted (eager JAX compiles
    # every op of the rasterizer at its first call)
    monkeypatch.setattr(jre, "rasterize", jax.jit(
        jre.rasterize, static_argnums=(2,)))
    monkeypatch.setattr(jre, "ssim", jax.jit(jre.ssim))
    monkeypatch.setattr(jre, "psnr", jax.jit(jre.psnr))
    target = random_scene(np.random.default_rng(2), n=60, sh_degree=1)
    g = random_scene(np.random.default_rng(3), n=60, sh_degree=1)
    cams = [make_camera(48, 32).with_delta(jnp.asarray(
        [0.02 * i, -0.01, 0.01, 0.03 * i, 0.0, 0.02])) for i in range(2)]
    jcfg = JConfig(max_pairs=1 << 12, max_per_tile=128, chunk=32,
                   backend="jnp", use_stream=False)
    gts = [np.asarray(jax.jit(lambda c: j_rasterize(target, c, jcfg).color)(
        c)) for c in cams]
    mj = jre.render_and_eval(
        g, [JInfo(uid=i, name=f"v{i}", camera=c) for i, c in
            enumerate(cams)], raster_cfg=jcfg,
        image_loader=lambda info: (gts[info.uid], None), log_fn=lambda s: 0)
    mt = render_and_eval(
        gaussians_to_torch(g),
        [CameraInfo(uid=i, name=f"v{i}", camera=camera_to_torch(c))
         for i, c in enumerate(cams)], out_dir=str(tmp_path),
        raster_cfg=RasterizerConfig(max_pairs=1 << 12, pallas_chunk=32),
        image_loader=lambda info: (gts[info.uid], None), log_fn=lambda s: 0)
    assert sorted(mt) == sorted(mj) == ["psnr", "ssim"]
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-5, err_msg=k)
    assert sorted(os.listdir(tmp_path / "renders")) == ["v0.png", "v1.png"]


def test_checkpoint_round_trip(tmp_path):
    """A state three steps in survives save/restore onto a template of the
    same capacity bit for bit, and training goes on identically."""
    g = gaussians_to_torch(random_scene(np.random.default_rng(4), n=50,
                                        sh_degree=1, capacity=64))
    cam = camera_to_torch(make_camera(32, 32))
    gt = torch.tensor(np.random.default_rng(5).uniform(0, 1, (32, 32, 3)),
                      dtype=torch.float32)
    cfg = ttrain.MapTrainConfig(random_background=True)
    rcfg = RasterizerConfig(max_pairs=1 << 12, pallas_chunk=32)
    state = ttrain.init_training(g, cfg, seed=3)
    for _ in range(3):
        state, _ = ttrain.train_step(state, cam, gt, cfg, rcfg)
    path = str(tmp_path / "ckpt" / "state.pt")
    save_checkpoint(path, state)
    assert os.listdir(tmp_path / "ckpt") == ["state.pt"]
    template = ttrain.init_training(gaussians_to_torch(random_scene(
        np.random.default_rng(6), n=50, sh_degree=1, capacity=64)), cfg)
    back = restore_checkpoint(path, template)
    assert back.step == 3
    for f in ttrain.TRAINABLE + ("live",):
        assert torch.equal(getattr(back.gaussians, f),
                           getattr(state.gaussians, f)), f
    for n in ttrain.TRAINABLE:
        for a, b in zip(back.opt_state[n], state.opt_state[n]):
            assert torch.equal(a, b), n
    s1, a1 = ttrain.train_step(state, cam, gt, cfg, rcfg)
    s2, a2 = ttrain.train_step(back, cam, gt, cfg, rcfg)
    assert float(a1["total"]) == float(a2["total"])
    assert torch.equal(s1.gaussians.xyz, s2.gaussians.xyz)
    small = ttrain.init_training(gaussians_to_torch(random_scene(
        np.random.default_rng(6), n=20, sh_degree=1, capacity=32)), cfg)
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(path, small)
