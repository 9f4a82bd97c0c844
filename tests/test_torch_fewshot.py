"""Few-shot map training in the port against the benchmark's plain
references (``gsbench/reference/dpt.py``, ``fewshot.py``), with no JAX:

- DPT_Hybrid at full width (12 ViT-B blocks, 768 wide) on the benchmark's
  seeded weights in the checkpoint's state-dict layout
  (``drivers/train_fewshot.py::draw_state_dict``: no bias is 0, no norm
  1 / 0), read through ``load_dpt``, against the plain network in float64;
  ``estimate_depth``'s protocol (both resizes and the net) at a 64x96
  network input, which the configuration states as 384x512 and the
  benchmark checks there on the card;
- that comparison fails for a net that drops any kind of bias, leaves the
  norms' affine out or swaps a block's two LayerNorms;
- one pseudo-term ``train_step`` against the plain two-view step: loss,
  pseudo term and every group's gradient;
- the capacity flags of a pseudo view that overflows the pair pool reach
  the audit;
- the spans and counters of the pseudo branch equal its calls over a short
  ``train_map`` run;
- the benchmark's count of DPT_Hybrid's work holds every weight the
  network reads.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gs_localization_torch.core.camera import Camera
from gs_localization_torch.core.gaussians import GaussianParams
from gs_localization_torch.data.scene import CameraInfo, SceneInfo
from gs_localization_torch.mapping import train as mtrain
from gs_localization_torch.ops import dpt
from gs_localization_torch.pipelines import train_map as tm
from gs_localization_torch.raster import RasterizerConfig
from gs_localization_torch.utils import profiling
from gsbench import scene, workcount_dpt
from gsbench.drivers import train_fewshot
from gsbench.reference import dpt as rdpt
from gsbench.reference import fewshot as rfewshot
from gsbench.reference import splat
from gsbench.reference import train as rtrain

W, H = 64, 48
SENSOR = {"width": W, "height": H, "fx": 585.0 * W / 640,
          "fy": 585.0 * W / 640, "cx": W / 2, "cy": H / 2}
MAP = {"num_gaussians": 2000, "sh_degree": 3,
       "box": [[-2.5, 2.5], [-2.0, 2.0], [2.0, 9.0]], "rgb": [0.05, 0.95],
       "sh_rest_std": 0.05, "log_scale": [-3.5, -2.0],
       "opacity_logit": [-1.0, 2.5]}
RASTER = RasterizerConfig(max_pairs=1 << 16, max_per_tile=1024,
                          use_stream=True)
TOL_NET = 5e-4       # of the reference's largest value: the JAX suite's
#                      bound on the same network (tests/test_dpt.py:168)
TOL_LOSS = 1e-5      # relative: float32 sums over 3,072 pixels
TOL_GRAD = 1e-4      # of the group's norm: float32 renders and sums


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
def state_dict():
    return {k: torch.from_numpy(v) for k, v in
            train_fewshot.draw_state_dict(np.random.default_rng(11)).items()}


@pytest.fixture(scope="module")
def net(state_dict):
    return dpt.load_dpt(state_dict, "cpu")


@pytest.fixture(scope="module")
def plain64(state_dict):
    return rdpt.weights(state_dict, torch.float64, "cpu")


def _gap(ours, ref):
    return float((ours.double() - ref).abs().max() / ref.abs().max())


@pytest.fixture(scope="module")
def probe(plain64):
    """A 64x96 image and the plain network's inverse depth of it."""
    img = torch.rand(64, 96, 3, generator=torch.Generator().manual_seed(5))
    return img, rdpt.forward(plain64, img.double())


def test_dpt_forward_matches_plain(net, probe):
    img, ref = probe
    ours = dpt.dpt_forward(net, img)
    assert ours.shape == (64, 96) and ref.std() > 0.05 * ref.abs().max()
    assert _gap(ours, ref) < TOL_NET


def _rcus(s):
    return [s[f"refinenet{k}"][u] for k in range(1, 5)
            for u in ("rcu1", "rcu2")]


def _norms(p, names):
    return [b[n] for b in p["blocks"] for n in names]


def _gns(p):
    r = p["resnet"]
    return [r["stem_gn"]] + [b[n] for st in r["stages"] for b in st
                             for n in ("gn1", "gn2", "gn3", "down_gn")
                             if n in b]


# each case -> the port's parameters it overwrites, and with what
PARAMETER_KINDS = {
    "patch_embed_bias": lambda p, s: [(p["embed_b"], 0.0)],
    "readout_bias": lambda p, s: [(p[f"readout{i}"]["b"], 0.0)
                                  for i in (3, 4)],
    "act_postprocess_bias": lambda p, s: [
        (p[k], 0.0) for k in ("post3_b", "post4a_b", "post4b_b")],
    "attention_bias": lambda p, s: [(b["attn"][k], 0.0) for b in p["blocks"]
                                    for k in ("qkv_b", "proj_b")],
    "mlp_bias": lambda p, s: [(b[k], 0.0) for b in p["blocks"]
                              for k in ("fc1_b", "fc2_b")],
    "residual_conv_unit_bias": lambda p, s: [
        (u[k], 0.0) for u in _rcus(s) for k in ("conv1_b", "conv2_b")],
    "fusion_out_conv_bias": lambda p, s: [(s[f"refinenet{k}"]["out_b"], 0.0)
                                          for k in range(1, 5)],
    "head_conv0_bias": lambda p, s: [(s["out1_b"], 0.0)],
    "head_conv2_bias": lambda p, s: [(s["out2_b"], 0.0)],
    "head_conv4_bias": lambda p, s: [(s["out3_b"], 0.0)],
    "layernorm_weight": lambda p, s: [(n["gamma"], 1.0)
                                      for n in _norms(p, ("ln1", "ln2"))],
    "layernorm_bias": lambda p, s: [(n["beta"], 0.0)
                                    for n in _norms(p, ("ln1", "ln2"))],
    "layernorms_swapped": lambda p, s: [
        (b[a][k], b[o][k].clone()) for b in p["blocks"]
        for a, o in (("ln1", "ln2"), ("ln2", "ln1")) for k in ("gamma", "beta")],
    "groupnorm_affine": lambda p, s: [
        (g[k], v) for g in _gns(p) for k, v in (("gamma", 1.0), ("beta", 0.0))],
}


@pytest.mark.parametrize("kind", sorted(PARAMETER_KINDS))
def test_plain_comparison_sees_every_parameter_kind(net, probe, kind):
    """A port that leaves one kind of parameter out (or swaps a block's
    LayerNorms) is off the plain network by more than the comparison's
    tolerance, on the benchmark's draw: none of its biases or norms is a
    no-op."""
    img, ref = probe
    edits = PARAMETER_KINDS[kind](net["pretrained"], net["scratch"])
    saved = [t.clone() for t, _ in edits]
    try:
        for t, v in edits:
            t.copy_(torch.as_tensor(v).expand_as(t))
        gap = _gap(dpt.dpt_forward(net, img), ref)
    finally:
        for (t, _), old in zip(edits, saved):
            t.copy_(old)
    assert gap > 5 * TOL_NET, gap


def test_estimate_depth_matches_plain(net, plain64, monkeypatch):
    monkeypatch.setattr(dpt, "NET_SIZE", (64, 96))
    img = torch.rand(48, 64, 3, generator=torch.Generator().manual_seed(6))
    ours = dpt.estimate_depth(net, img, 48, 64)
    ref = rdpt.estimate_depth(plain64, img.double(), (64, 96))
    assert ours.shape == (48, 64)
    assert _gap(ours, ref) < TOL_NET
    est = dpt.make_dpt_estimator(net)(img.numpy())
    np.testing.assert_array_equal(est, ours.numpy())


def test_dpt_work_counts_every_weight_read(state_dict):
    unused = sum(v.numel() for k, v in state_dict.items()
                 if k.startswith("scratch.refinenet4.resConfUnit1."))
    w = workcount_dpt.count()
    assert w.params == sum(v.numel() for v in state_dict.values()) - unused
    assert 1.7e11 < w.flops / 2 < 1.8e11      # ~174 G multiply-adds


def _cam(pose):
    return Camera.from_numpy(pose.astype(np.float32), SENSOR["fx"],
                             SENSOR["fy"], SENSOR["cx"], SENSOR["cy"], W, H,
                             device="cpu")


@pytest.fixture(scope="module")
def views():
    """The seeded map and four views of it within 0.1 m / 0.03 rad."""
    m = scene.make_map(MAP, 21, "cpu")
    poses = scene.moved_poses(4, 0.1, 0.03, 21, 1)
    cams = [scene.camera(SENSOR, torch.tensor(p, dtype=torch.float32))
            for p in poses]
    targets = scene.render_targets(m, cams)
    colors = np.clip(m.sh[:, 0].numpy() * splat.SH_C0 + 0.5, 0.0, 1.0)
    return m, poses, cams, targets, colors


def test_pseudo_step_matches_plain(views, monkeypatch):
    m, poses, cams, targets, colors = views
    g = GaussianParams.from_pcd(m.xyz.numpy(), colors, sh_degree=3,
                                capacity=4096, device="cpu")
    mcfg = mtrain.MapTrainConfig(spatial_scale=3.0)
    state = mtrain.init_training(g, mcfg)
    gt, gt_depth = targets[0]
    pcam = _cam(poses[2])
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    prior = 40.0 + 10.0 * torch.sin(xx / 9.0) + 0.5 * yy
    grads = []

    def keep(loss, params, offset, _orig=mtrain._grads):
        grads.append(_orig(loss, params, offset))
        return grads[-1]

    monkeypatch.setattr(mtrain, "_grads", keep)
    _, aux = mtrain.train_step(state, _cam(poses[0]), gt, mcfg, RASTER,
                               gt_depth=gt_depth, pseudo_camera=pcam,
                               pseudo_view_depth=prior)
    live = g.live
    params = {k: getattr(g, k)[live].double() for k in rtrain.GROUPS}
    view = (cams[0].at(cams[0].w2c.double()), gt.double(), gt_depth.double())
    ref = rfewshot.pseudo_step(
        params, view, cams[0].at(pcam.w2c.double()), prior.double(),
        g.sh_degree, dataclasses.asdict(mcfg))
    assert ref.pseudo > 1e-3
    assert abs(float(aux["total"]) - ref.loss) < TOL_LOSS * ref.loss
    assert abs(float(aux["pseudo_view"]) - ref.pseudo) < TOL_LOSS * ref.pseudo
    for k, gr in zip(rtrain.GROUPS, grads[0]):
        r = ref.grads[k]
        scale = max(float(r.norm()), 1e-12)
        assert float((gr[live].double() - r).norm()) <= TOL_GRAD * scale, k


def test_pseudo_view_overflow_reaches_the_audit(views):
    """The training view looks away from the map; the pseudo view sees it
    all and outgrows a 256-pair pool, so the step's flags, and with them
    the audit's capacities, take the pseudo view's."""
    m, poses, _, targets, colors = views
    g = GaussianParams.from_pcd(m.xyz.numpy(), colors, sh_degree=3,
                                device="cpu")
    mcfg = mtrain.MapTrainConfig(spatial_scale=3.0)
    state = mtrain.init_training(g, mcfg)
    away = np.diag([-1.0, 1.0, -1.0, 1.0])       # turned about y
    small = RASTER.replace(max_pairs=256)
    gt, _ = targets[0]
    prior = torch.rand(H, W, generator=torch.Generator().manual_seed(2))
    _, alone = mtrain.train_step(state, _cam(away), gt, mcfg, small)
    assert not bool(alone["overflow"])
    assert tm._audit_capacities(10, alone, small, lambda s: None) is small
    _, aux = mtrain.train_step(state, _cam(away), gt, mcfg, small,
                               pseudo_camera=_cam(poses[1]),
                               pseudo_view_depth=prior)
    assert bool(aux["overflow"])
    assert int(aux["max_tile_count"]) > int(alone["max_tile_count"])
    grown = tm._audit_capacities(10, aux, small, lambda s: None)
    assert grown.max_pairs == 2 * small.max_pairs


def test_pseudo_branch_records_its_calls(views, net, monkeypatch):
    """18 iterations with a pseudo step every 5 from step 10: 2 pseudo
    steps, each one estimator call; under the profiler the branch's
    spans and counters count the same."""
    m, poses, _, targets, colors = views
    monkeypatch.setattr(dpt, "NET_SIZE", (32, 32))
    infos = [CameraInfo(uid=i, name=f"v{i}", camera=_cam(p))
             for i, p in enumerate(poses)]
    sc = SceneInfo(train_cameras=infos, test_cameras=[],
                   points=m.xyz.numpy(), colors=colors, extent=3.0)
    cfg = tm.TrainPipelineConfig(
        iterations=18, sh_degree=3, densify_from=1000, log_every=1000,
        test_iterations=(), save_iterations=(), start_sample_pseudo=9,
        sample_pseudo_interval=5, seed=4)
    est, calls = dpt.make_dpt_estimator(net), []

    def estimator(rgb):
        calls.append(rgb.shape)
        return est(rgb)

    images = {i: (t[0].numpy(), t[1].numpy()) for i, t in enumerate(targets)}
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tm.train_map(sc, None, cfg, mtrain.MapTrainConfig(spatial_scale=3.0),
                     RASTER, image_loader=lambda info: images[info.uid],
                     depth_estimator=estimator, log_fn=lambda s: None,
                     device="cpu")
    rec = profiling.records()
    profiling.reset()
    names = [s["name"] for s in rec["spans"]]
    assert len(calls) == 2 and calls[0] == (H, W, 3)
    for name in ("train/pseudo", "pseudo/render", "pseudo/prior",
                 "prior/net", "train/pseudo_render"):
        assert names.count(name) == 2, name
    assert names.count("prior/resize") == 4
    for name in ("host_sync/prior", "host_sync/pseudo_view"):
        assert rec["counters"][name] == 2, name
