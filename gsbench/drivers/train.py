"""Map training as the scene runner trains: one ``train_map`` call (which
drives ``train_step``), timed over the steps that follow the warm-up.

Traffic parameters (``traffic/<mix>.json``): ``views`` RGB-D training views,
each the bench camera moved by ``pose_trans_m`` and ``pose_rot_rad`` in
seeded directions, rendered by the plain renderer from the seeded map; the
map to train starts from ``from_pcd`` of that map's centres and DC colours
(the configuration's training preset and map preset, the stream layout);
``warmup_steps`` steps run in set-up, and the window times every later step
until ``--seconds`` have passed, densification rounds and capacity audits
included.

The check holds the first three steps (run in set-up through the same call)
against the plain reference from the same points and views: each step's
loss, every parameter group's first gradient as Adam holds it after one
step, and every group's change after three steps; and the window's first
densification round against the plain round on the state it was given.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from gsbench import scene, workcount
from gsbench.reference import densify as rdensify
from gsbench.reference import splat
from gsbench.reference import train as rtrain


class State:
    pass


class _WindowClosed(Exception):
    pass


def setup(ctx) -> State:
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.data.scene import CameraInfo, SceneInfo
    from gs_localization_torch.pipelines import presets
    from gs_localization_torch.raster import RasterizerConfig

    cfg, mix, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    sensor = cfg["sensor"]
    st = State()
    st.map = scene.make_map(cfg["map"], seed, dev)
    n = int(mix["views"])
    poses = scene.moved_poses(n, mix["pose_trans_m"], mix["pose_rot_rad"],
                              seed, 1)
    st.cams = [scene.camera(sensor, torch.tensor(p, dtype=torch.float32,
                                                 device=dev)) for p in poses]
    targets = scene.render_targets(st.map, st.cams)
    st.images = {i: (c.cpu().numpy(), d.cpu().numpy())
                 for i, (c, d) in enumerate(targets)}
    del targets
    st.points = st.map.xyz.cpu().numpy()
    st.colors = np.clip(st.map.sh[:, 0].cpu().numpy() * splat.SH_C0 + 0.5,
                        0.0, 1.0)
    centers = np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])
    st.extent = float(1.1 * np.linalg.norm(
        centers - centers.mean(0, keepdims=True), axis=1).max())
    infos = [CameraInfo(uid=i, name=f"view{i:03d}", camera=Camera.from_numpy(
        p.astype(np.float32), c.fx, c.fy, c.cx, c.cy, c.width, c.height,
        device=dev)) for i, (p, c) in enumerate(zip(poses, st.cams))]
    st.view_of = {id(info.camera): info.uid for info in infos}
    st.scene = SceneInfo(train_cameras=infos, test_cameras=[],
                         points=st.points, colors=st.colors,
                         extent=st.extent)
    st.tcfg = getattr(presets, cfg["presets"]["training"])()
    st.tcfg.seed = int(seed) % (1 << 31)
    st.mcfg = getattr(presets, cfg["presets"]["map"])(st.extent)
    st.rcfg = RasterizerConfig(**cfg["raster"])
    st.warmup = int(mix["warmup_steps"])
    return st


def run_window(ctx, st) -> dict:
    from gs_localization_torch.pipelines import train_map as tm

    orig_step, orig_densify = tm.train_step, tm.densify_and_prune
    st.first, st.densify, st.losses, st.traced_map = [], None, [], None

    def record_step(state, camera, *args, **kwargs):
        if st.traced_map is None and ctx.device_trace.prof is not None:
            st.traced_map = _snapshot(state.gaussians)
        new_state, aux = orig_step(state, camera, *args, **kwargs)
        if len(st.first) < 3:
            st.first.append({"view": st.view_of[id(camera)],
                             "before": state if not st.first else None,
                             "after": new_state if len(st.first) != 1
                             else None,          # steps 1 and 3 are kept
                             "loss": aux["total"]})
        done = len(st.first) == 3 and (not ctx.trace
                                       or st.traced_map is not None)
        if done and tm.train_step is record_step:
            tm.train_step = orig_step
        return new_state, aux

    def record_densify(gaussians, state, opt_state, *args, **kwargs):
        out = orig_densify(gaussians, state, opt_state, *args, **kwargs)
        if st.densify is None:
            st.densify = {"gaussians": gaussians, "stats": state,
                          "kwargs": kwargs, "out": out}
        return out

    def hook(it, aux):
        if it < st.warmup:
            return
        if it == st.warmup:
            ctx.start_window()
            return
        st.losses.append(aux["total"])
        if ctx.unit_done():
            raise _WindowClosed

    tm.train_step, tm.densify_and_prune = record_step, record_densify
    try:
        tm.train_map(st.scene, None, st.tcfg, st.mcfg, st.rcfg,
                     image_loader=lambda info: st.images[info.uid],
                     log_fn=ctx.log, device=ctx.device, step_hook=hook)
    except _WindowClosed:
        pass
    finally:
        tm.train_step, tm.densify_and_prune = orig_step, orig_densify
    window = ctx.end_window()
    steps = len(st.losses)
    failed = int((~torch.isfinite(torch.stack(st.losses))).sum())
    return {"attempted": steps, "failed": failed, "window_s": window,
            "end_to_end": {"train_step_ms": 1e3 * window / steps}}


def _snapshot(g) -> dict:
    """A copy of the program's map as a traced step starts (no wait for
    the device)."""
    return {"xyz": g.xyz.clone(), "scaling": g.scaling.clone(),
            "rotation": g.rotation.clone(), "opacity": g.opacity.clone(),
            "live": g.live.clone(), "sh_degree": int(g.sh_degree)}


def work(st, view: int) -> workcount.Render:
    """The work of one traced step on ``view``: the benchmark's plain walk
    over the map as it stood when the trace began (counted once per view,
    on demand, after the window). Only the walk counts, so the map is taken
    without its colours."""
    if not hasattr(st, "work"):
        st.work = {}
        g = st.traced_map
        live = g["live"]
        xyz = g["xyz"][live]
        st.work_map = splat.Map(
            xyz, g["scaling"][live], g["rotation"][live],
            g["opacity"][live].reshape(-1),
            torch.zeros((xyz.shape[0], 1, 3), device=xyz.device), 0)
    if view not in st.work:
        cam = st.cams[view]
        with torch.no_grad():
            scr = splat.project(st.work_map, cam)
            tiles = splat.bin_tiles(scr, cam)
            b = splat.blend(scr.table, tiles, cam)
            st.work[view] = workcount.count(b, tiles, cam.width, cam.height)
    return st.work[view]


def flops(st, view: int) -> float:
    """Operations of one traced step on ``view`` (SH at the degree the map
    had when the trace began)."""
    return workcount.training_step_flops(work(st, view),
                                         st.traced_map["sh_degree"])


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _worst_leaf(prog: dict, ref: dict, keep) -> float:
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def reference_steps(st, dtype):
    dev = st.map.xyz.device
    params = rtrain.init_from_points(
        st.map.xyz.to(dtype), torch.tensor(st.colors, device=dev).to(dtype),
        st.map.sh_degree)
    views = []
    for rec in st.first:
        cam = st.cams[rec["view"]]
        img, dep = st.images[rec["view"]]
        views.append((cam.at(cam.w2c.to(dtype)),
                      torch.tensor(img, device=dev).to(dtype),
                      torch.tensor(dep, device=dev).to(dtype)))
    cfg = dataclasses.asdict(st.mcfg)
    return params, rtrain.train_steps(params, views, 0, cfg)


def _program_side(st, n):
    before = st.first[0]["before"].gaussians
    after1 = st.first[0]["after"].opt_state
    after3 = st.first[2]["after"].gaussians
    return ([float(r["loss"]) for r in st.first],
            _norms({k: after1[k].mu[:n] / 0.1 for k in rtrain.GROUPS}),
            _norms({k: getattr(after3, k)[:n] - getattr(before, k)[:n]
                    for k in rtrain.GROUPS}))


def _reference_side(st, dtype):
    p0, steps = reference_steps(st, dtype)
    return ([s.loss for s in steps], _norms(steps[0].grads),
            _norms({k: steps[2].params[k] - p0[k] for k in rtrain.GROUPS}))


def step_numbers(st, control=None) -> dict:
    """The three steps' numbers: loss gap, first-gradient gap and change
    gap, the latter two by the worst group. With ``control`` (a dtype), the
    reference computed in that dtype takes the program's place."""
    n = st.points.shape[0]
    loss_r, g_ref, c_ref = _reference_side(st, torch.float64)
    loss_p, g_prog, c_prog = (_program_side(st, n) if control is None
                              else _reference_side(st, control))
    med = float(np.median(list(g_ref.values())))
    # groups whose reference gradient is nought to rounding move under Adam
    # by rounding alone: left out by their gradient, not by name
    keep = [k for k in rtrain.GROUPS if g_ref[k] >= 1e-3 * med]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(loss_p, loss_r))
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(g_prog, g_ref, keep),
            "change_gap": _worst_leaf(c_prog, c_ref, keep)}


def _round(d, dtype):
    g, s, kw = d["gaussians"], d["stats"], d["kwargs"]
    c = lambda t: t.to(dtype)   # noqa: E731
    return rdensify.densify_round(
        c(g.scaling), c(g.opacity), g.live, c(s.grad_accum), c(s.denom),
        c(s.max_radii), kw["grad_threshold"], kw["min_opacity"],
        kw["extent"], kw["max_screen_size"], kw["percent_dense"])


def densify_numbers(st, control=None) -> dict:
    """The window's first densification round against the plain round on
    the state the program was given (float32, the state's own dtype)."""
    d = st.densify
    ref = _round(d, torch.float32)
    new_g, report = d["out"][0], d["out"][3]
    if control is None:
        counts = (int(report.num_cloned), int(report.num_split),
                  int(report.num_pruned))
        live = new_g.live
        values = (torch.sort(new_g.opacity[live].reshape(-1)).values,
                  torch.sort(new_g.scaling[live].reshape(-1)).values)
        exact = int(report.dropped) == 0
    else:
        alt = _round(d, control)
        counts = (alt.cloned, alt.split, alt.pruned)
        values, exact = (alt.opacity, alt.scaling), True
    out = {"densify_count_gap": float(
        sum(abs(a - b) for a, b in zip(counts, ref[:3])))}
    if exact:      # a round short of capacity keeps an arbitrary subset
        out["densify_value_gap"] = max(rdensify.gap(values[0], ref.opacity),
                                       rdensify.gap(values[1], ref.scaling))
    return out


def check(ctx, st, window, control=None) -> dict:
    st.scene = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    nums = step_numbers(st, control)
    if st.densify is not None:
        nums.update(densify_numbers(st, control))
    else:
        print("gsbench: no densification round in the window; not compared",
              file=sys.stderr)
    lim = ctx.limits
    return {k: {"value": v, "limit": lim[k]} for k, v in nums.items()}
