"""Closed-loop localization: one client sends one query at a time to
``gs_localization_torch.pipelines.localize.localize_queries`` and sends the
next as soon as the last one's pose is back on the host.

Traffic parameters (``traffic/<mix>.json``): ``pool`` queries; each query's
true pose is the bench camera moved by ``pose_trans_m`` and
``pose_rot_rad`` in seeded directions, its target (RGB, and depth for an
RGB-D sensor) rendered by the plain renderer, its initial pose the true
pose moved by a tangent whose components have magnitudes uniform in
``init_tangent`` with random signs; a seeded focal scale per query in
1 +- the configuration's ``focal_jitter``. Queries cycle through the pool
in a seeded order. ``warmup_calls`` queries run before the window; the
capacities they grew to by ``localize_queries``' own rule are kept.
``check_queries`` queries of the window, the slowest among them, are held
against the plain reference's refinement of the same query: every answer
the window gave for them, by its pose, its iterations, and its first
iteration's loss and tangent gradient.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from gsbench import scene, workcount
from gsbench.reference import splat, track


class Capture:
    """What each of the program's refinements gave, taken without waiting
    for the device: the capacities it ran at (``raster_cfg``), its
    iterations and capacity flag, and its first iteration's loss and
    tangent gradient (a hook on the first tangent it differentiates).
    ``with capture():`` wraps ``loc.refine.refine_pose``,
    ``loc.refine.tracking_loss`` and ``core.se3.apply_delta``, which the
    program looks up at call time."""

    def __init__(self):
        self.calls = []
        self._open = None

    @contextlib.contextmanager
    def __call__(self):
        from gs_localization_torch.core import se3
        from gs_localization_torch.loc import refine

        inner = (refine.refine_pose, refine.tracking_loss, se3.apply_delta)

        def refine_pose(*args, **kwargs):
            rec = {"raster_cfg": args[5] if len(args) > 5
                   else kwargs.get("raster_cfg"), "grad0": None,
                   "loss0": None, "hooked": False}
            self._open = rec
            try:
                res = inner[0](*args, **kwargs)
            finally:
                self._open = None
            rec.update(iters=int(res.num_iters), overflow=res.overflow)
            self.calls.append(rec)
            return res

        def tracking_loss(*args, **kwargs):
            out = inner[1](*args, **kwargs)
            rec = self._open
            if rec is not None and rec["loss0"] is None:
                rec["loss0"] = out.detach()
            return out

        def apply_delta(tau, w2c):
            rec = self._open
            if rec is not None and tau.requires_grad and not rec["hooked"]:
                rec["hooked"] = True
                tau.register_hook(lambda g: rec.__setitem__(
                    "grad0", g.detach().clone()))
            return inner[2](tau, w2c)

        refine.refine_pose, refine.tracking_loss, se3.apply_delta = (
            refine_pose, tracking_loss, apply_delta)
        try:
            yield self
        finally:
            refine.refine_pose, refine.tracking_loss, se3.apply_delta = inner


def _program_map(m: splat.Map):
    from gs_localization_torch.core.gaussians import GaussianParams

    n = m.xyz.shape[0]
    return GaussianParams(
        xyz=m.xyz.contiguous(), features_dc=m.sh[:, :1].contiguous(),
        features_rest=m.sh[:, 1:].contiguous(),
        scaling=m.log_scale.contiguous(), rotation=m.quat.contiguous(),
        opacity=m.opacity_logit[:, None].contiguous(),
        live=torch.ones(n, dtype=torch.bool, device=m.xyz.device),
        sh_degree=m.sh_degree, max_sh_degree=m.sh_degree)


class State:
    pass


def setup(ctx) -> State:
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.pipelines import presets
    from gs_localization_torch.pipelines.localize import QuerySpec
    from gs_localization_torch.raster import RasterizerConfig

    cfg, mix, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    sensor = cfg["sensor"]
    st = State()
    st.map = scene.make_map(cfg["map"], seed, dev)
    n = int(mix["pool"])
    poses = scene.moved_poses(n, mix["pose_trans_m"], mix["pose_rot_rad"],
                              seed, 1)
    taus = scene.init_tangents(n, *mix["init_tangent"], seed, 2)
    jitter = float(sensor.get("focal_jitter", 0.0))
    focal = 1.0 + jitter * scene.rng(seed, 3).uniform(-1.0, 1.0, n)
    st.true_cams = [scene.camera(sensor, torch.tensor(
        p, dtype=torch.float32, device=dev), float(f))
        for p, f in zip(poses, focal)]
    st.inits = [scene.se3_exp_np(t) @ p for t, p in zip(taus, poses)]
    targets = scene.render_targets(st.map, st.true_cams)
    st.depth = bool(sensor.get("depth", False))
    st.targets = [(c.cpu().numpy(), d.cpu().numpy() if st.depth else None)
                  for c, d in targets]
    del targets

    st.gaussians = _program_map(st.map)
    st.queries = []
    for i, (cam, init) in enumerate(zip(st.true_cams, st.inits)):
        pc = Camera.from_numpy(init.astype(np.float32), cam.fx, cam.fy,
                               cam.cx, cam.cy, cam.width, cam.height,
                               device=dev)
        img, dep = st.targets[i]
        st.queries.append(QuerySpec(name=f"q{i:03d}", camera=pc, image=img,
                                    depth=dep))
    st.lcfg = getattr(presets, cfg["presets"]["localize"])()
    st.rcfg = RasterizerConfig(**cfg["raster"])
    st.order = scene.rng(seed, 4).permutation(n)
    st.capture = Capture()
    with st.capture():
        for i in range(int(mix["warmup_calls"])):
            _call(ctx, st, st.queries[st.order[i % n]])
            # the capacities the call ended at, grown by its own rule
            st.rcfg = st.capture.calls[-1]["raster_cfg"]
    return st


def _call(ctx, st, q):
    from gs_localization_torch.pipelines import localize

    res, _ = localize.localize_queries(st.gaussians, [q], st.lcfg, st.rcfg,
                                       log_fn=ctx.log)
    return res[q.name]


def work(st, idx: int) -> workcount.Render:
    """The work of one iteration of pool query ``idx``: the plain walk at
    its initial pose (counted once, on demand, after the window)."""
    if not hasattr(st, "work"):
        st.work = {}
    if idx not in st.work:
        cam = st.true_cams[idx]
        c0 = cam.at(torch.tensor(st.inits[idx], dtype=torch.float32,
                                 device=cam.w2c.device))
        with torch.no_grad():
            scr = splat.project(st.map, c0)
            tiles = splat.bin_tiles(scr, c0)
            b = splat.blend(scr.table, tiles, c0)
        st.work[idx] = workcount.count(b, tiles, c0.width, c0.height)
    return st.work[idx]


def flops(st, idx: int, iters: int) -> float:
    """Operations of a query that ran ``iters`` iterations."""
    r = work(st, idx)
    rebins = -(-iters // max(st.lcfg.tracking.rebin_every, 1))
    return (iters * workcount.tracking_iteration_flops(r)
            + rebins * workcount.rebin_flops(r, st.map.sh_degree))


def run_window(ctx, st) -> dict:
    n = len(st.queries)
    st.done, lat, calls = [], [], st.capture.calls
    with st.capture():
        ctx.start_window()
        k = 0
        while True:
            idx = int(st.order[k % n])
            c0 = len(calls)
            t1 = time.perf_counter()
            pose = _call(ctx, st, st.queries[idx])
            lat.append(time.perf_counter() - t1)
            st.done.append((idx, pose, calls[c0:]))
            k += 1
            if ctx.unit_done():
                break
        window = ctx.end_window()
    st.latency = lat
    grown = sum(len(c) > 1 for _, _, c in st.done)
    if grown:
        print(f"gsbench: capacity growth inside the window in {grown} "
              f"queries", file=sys.stderr)
    failed = sum(not np.all(np.isfinite(p)) for _, p, _ in st.done)
    return {"attempted": k, "failed": failed,
            "units": [i for i, _, _ in st.done],
            "window_s": window,
            "end_to_end": {
                "loc_queries_per_s": k / window,
                "loc_query_ms.p95": float(np.percentile(
                    1e3 * np.asarray(lat), 95))}}


def tracking_cfg(st) -> dict:
    tc = dataclasses.asdict(st.lcfg.tracking)
    tc["edge_threshold"] = st.lcfg.edge_threshold
    return tc


def reference_track(st, idx: int, dtype) -> track.Track:
    """The plain refinement of pool query ``idx`` in ``dtype``."""
    cam = st.true_cams[idx]
    c0 = cam.at(torch.tensor(st.inits[idx], dtype=dtype,
                             device=cam.w2c.device))
    img, dep = st.targets[idx]
    dev = cam.w2c.device
    gt = torch.tensor(img, device=dev).to(dtype)
    gtd = None if dep is None else torch.tensor(dep, device=dev).to(dtype)
    return track.refine(st.map.to(dtype), c0, gt, gtd, tracking_cfg(st))


def pose_gap(a: np.ndarray, b: np.ndarray):
    """Camera-centre distance (m) and rotation angle (rad) between two
    world-to-camera poses."""
    ca = -a[:3, :3].T @ a[:3, 3]
    cb = -b[:3, :3].T @ b[:3, 3]
    m = a[:3, :3] @ b[:3, :3].T
    v = 0.5 * np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                        m[1, 0] - m[0, 1]])
    angle = np.arctan2(np.linalg.norm(v), 0.5 * (np.trace(m) - 1))
    return float(np.linalg.norm(ca - cb)), float(angle)


def sample(ctx, st) -> list:
    """Pool indices to check: the slowest query of the window and others
    drawn from the seed among those the window answered."""
    k = int(ctx.traffic["check_queries"])
    slowest = st.done[int(np.argmax(st.latency))][0]
    rest = sorted({i for i, _, _ in st.done} - {slowest})
    r = scene.rng(ctx.seed, 5)
    pick = list(r.choice(rest, size=min(k - 1, len(rest)), replace=False))
    return [slowest] + [int(i) for i in pick]


def _answer(pose, iters, loss0, grad0) -> dict:
    return {"pose": np.asarray(pose, np.float64), "iters": int(iters),
            "loss": np.nan if loss0 is None else float(loss0),
            "grad0": None if grad0 is None
            else grad0.detach().double().cpu().numpy()}


def _from_track(t: track.Track) -> dict:
    return _answer(t.w2c.double().cpu().numpy(), t.iters, t.loss0, t.grad0)


def _from_program(pose, calls) -> dict:
    last = calls[-1] if calls else {"iters": -1, "loss0": None,
                                    "grad0": None}
    return _answer(pose, last["iters"], last["loss0"], last["grad0"])


def gaps(ans: dict, ref: dict) -> dict:
    """One answer against the reference's: camera-centre distance and
    rotation angle of the poses, the iterations' difference, and the first
    iteration's losses' and tangent gradients' relative gaps."""
    gm, gr = pose_gap(ans["pose"], ref["pose"])
    grad = (np.inf if ans["grad0"] is None else float(
        np.linalg.norm(ans["grad0"] - ref["grad0"])
        / np.linalg.norm(ref["grad0"])))
    return {"pose_gap_m": gm, "pose_gap_rad": gr,
            "iters_gap": float(abs(ans["iters"] - ref["iters"])),
            "loss_gap": abs(ans["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_gap": grad}


def check(ctx, st, window, control=None) -> dict:
    """Every answer of the sampled queries against the reference. With
    ``control`` (a dtype), the reference computed in that dtype takes the
    program's place."""
    st.gaussians = st.queries = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    worst = {}
    for idx in sample(ctx, st):
        ref = _from_track(reference_track(st, idx, torch.float64))
        answers = [_from_program(pose, calls)
                   for j, pose, calls in st.done if j == idx]
        if control is not None:
            answers = [_from_track(reference_track(st, idx, control))]
        for ans in answers:
            for k, v in gaps(ans, ref).items():
                v = v if np.isfinite(v) else np.inf
                worst[k] = max(worst.get(k, 0.0), v)
    lim = ctx.limits
    return {k: {"value": v, "limit": lim[k]} for k, v in worst.items()}
