"""Few-shot map training as LoGS runs it on a scene of fewer than 200
views: the ``train`` driver's ``train_map`` call, given the depth estimator
the scene runner builds (``ops/dpt.py::load_dpt`` on a state dict in
``dpt_hybrid-midas-501f0c75.pt``'s layout, then ``make_dpt_estimator``),
so that ``train_map``'s own few-shot branch renders a pseudo view every
``sample_pseudo_interval`` steps, runs DPT_Hybrid on its colour on the card
and holds the pseudo view's depth to that prior.

The configuration adds to ``train``'s: ``fewshot`` (LoGS's interval,
pseudo views per tour edge, weight and view-count threshold),
``schedule`` (the pseudo phase's first and last step) and ``depth_prior``
(the network's widths, checked against the network the program loaded,
and its input size). Every tensor of the network's checkpoint is drawn from
the seed in set-up (``draw_state_dict``); no file is written. Traffic
parameters are ``train``'s.

The check keeps ``train``'s numbers (the first three steps and the first
densification round) and adds, for the first pseudo step: the prior the
estimator returned against the plain DPT_Hybrid (``reference/dpt.py``) in
float64 on the same rendered colour, by the largest gap over the
reference's largest value; and the step's main-view loss, its pseudo term
and every parameter group's gradient against the plain two-view step
(``reference/fewshot.py``) from the same parameters, views and prior.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from gsbench import registry, scene, workcount_dpt
from gsbench.reference import dpt as rdpt
from gsbench.reference import fewshot as rfewshot
from gsbench.reference import train as rtrain

base = registry.driver("train")
State, work, flops = base.State, base.work, base.flops

PRIOR_STREAM = 6      # the seed's stream of the network's weights
HEAD_CONVS = "scratch.output_conv."
HEAD = HEAD_CONVS + "4.weight"


def draw_state_dict(rng: np.random.Generator) -> dict:
    """DPT_Hybrid's weights in ``dpt_hybrid-midas-501f0c75.pt``'s layout
    (keys and shapes from ``ops/dpt.py::dpt_state_dict``), every tensor
    drawn from ``rng``, so that no bias or norm reads as a no-op:

    - kernels, linear weights, cls token and position embeddings as
      ``init_params`` draws them;
    - every norm's weight U(0.5, 1.5);
    - every bias and norm bias 0.1 U(0.5, 1.5) with a random sign, except
      the head's (``scratch.output_conv``), at 10 U(0.5, 1.5): the head reads
      the decoder's residual sums, whose RMS grows to ~75 through the four
      fusion blocks, where a bias of 0.1 would move the prior by less than
      the check resolves;
    - the head's last 1x1 kernel in absolute value: it reads a ReLU's
      output, so the inverse depth comes out positive over the frame, as a
      trained MiDaS's does (the raw draw leaves the prior at 0 over most of
      the frame for about half the seeds)."""
    from gs_localization_torch.ops import dpt

    def signed(shape, scale):
        return (scale * rng.uniform(0.5, 1.5, shape)
                * rng.choice((-1.0, 1.0), shape)).astype(np.float32)

    sd = dpt.dpt_state_dict(dpt.init_params(rng))
    for key, v in sd.items():
        layer, kind = key.rsplit(".", 2)[-2:]
        if layer.startswith("norm") and kind == "weight":
            sd[key] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif kind == "bias":
            sd[key] = signed(v.shape, 10.0 if key.startswith(HEAD_CONVS)
                             else 0.1)
    sd[HEAD] = np.abs(sd[HEAD])
    return sd


def _check_widths(spec: dict, dpt, net) -> None:
    """The configuration's network is the one the program loaded, width
    for width."""
    p, s = net["pretrained"], net["scratch"]
    have = {"input": list(dpt.NET_SIZE), "embed_dim": p["embed_b"].numel(),
            "heads": dpt.HEADS, "blocks": len(p["blocks"]),
            "mlp_dim": p["blocks"][0]["fc1_b"].numel(),
            "stages": [len(b) for b in p["resnet"]["stages"]],
            "features": s["layer1_rn"].shape[0]}
    want = {k: spec[k] for k in have}
    if want != have:
        raise ValueError(f"depth_prior {want} is not the program's {have}")


def setup(ctx) -> State:
    from gs_localization_torch.ops import dpt

    st = base.setup(ctx)
    cfg = ctx.config
    few, sched = cfg["fewshot"], cfg["schedule"]
    for key in ("sample_pseudo_interval", "pseudo_per_edge",
                "fewshot_threshold"):
        setattr(st.tcfg, key, int(few[key]))
    st.tcfg.start_sample_pseudo = int(sched["start_sample_pseudo"])
    st.tcfg.end_sample_pseudo = int(sched["end_sample_pseudo"])
    st.mcfg = dataclasses.replace(
        st.mcfg, lambda_pseudo_view=float(few["lambda_pseudo_view"]))
    if st.mcfg.random_background:
        raise ValueError("the plain pseudo step renders no background")
    st.net_size = tuple(cfg["depth_prior"]["input"])
    sd = draw_state_dict(scene.rng(ctx.seed, PRIOR_STREAM))
    st.state_dict = {k: torch.from_numpy(v) for k, v in sd.items()}
    net = dpt.load_dpt(st.state_dict, ctx.device)
    _check_widths(cfg["depth_prior"], dpt, net)
    estimator = dpt.make_dpt_estimator(net)
    st.prior_call = None

    def depth_estimator(rgb):
        out = estimator(rgb)
        if st.prior_call is None:
            st.prior_call = (np.array(rgb), np.array(out))
        return out

    st.estimator = depth_estimator
    return st


def run_window(ctx, st) -> dict:
    """``train``'s window with the estimator passed to ``train_map``; the
    first pseudo step's state, views, prior, aux and gradients are kept
    (``mapping/train.py::_grads`` wrapped for that step alone), and the
    pseudo cameras ``train_map`` generates are kept for the work count."""
    from gs_localization_torch.mapping import train as mtrain
    from gs_localization_torch.pipelines import train_map as tm

    orig_map, orig_step = tm.train_map, tm.train_step
    orig_poses = tm.generate_pseudo_poses
    st.pseudo, st.pseudo_cams = None, []

    def poses(*args, **kwargs):
        st.pseudo_cams = orig_poses(*args, **kwargs)
        return st.pseudo_cams

    def capture(state, camera, *args, **kwargs):
        if st.pseudo is not None or kwargs.get("pseudo_camera") is None:
            if st.pseudo is not None and tm.train_step is capture:
                tm.train_step = orig_step
            return orig_step(state, camera, *args, **kwargs)
        grads, orig_grads = [], mtrain._grads

        def keep(loss, params, offset):
            grads.append(orig_grads(loss, params, offset))
            return grads[-1]

        mtrain._grads = keep
        try:
            new_state, aux = orig_step(state, camera, *args, **kwargs)
        finally:
            mtrain._grads = orig_grads
        st.pseudo = {"gaussians": state.gaussians,
                     "view": st.view_of[id(camera)],
                     "camera": kwargs["pseudo_camera"],
                     "prior": kwargs["pseudo_view_depth"],
                     "loss": aux["total"], "term": aux["pseudo_view"],
                     "grads": grads[0]}
        return new_state, aux

    tm.train_map = functools.partial(orig_map, depth_estimator=st.estimator)
    tm.train_step, tm.generate_pseudo_poses = capture, poses
    try:
        window = base.run_window(ctx, st)
    finally:
        tm.train_map, tm.train_step = orig_map, orig_step
        tm.generate_pseudo_poses = orig_poses
    first = len(st.cams)
    st.pseudo_of = {id(c): first + k for k, c in enumerate(st.pseudo_cams)}
    st.cams = st.cams + [st.cams[0].at(c.w2c.detach())
                         for c in st.pseudo_cams]
    return window


def steps(ctx, st, records) -> list:
    """Each window step's (view, pseudo view or None) from the binning
    span's camera notes: a pseudo step bins its pseudo view twice (the
    render without gradients before its view, the render in the graph
    after it)."""
    out, pending, seen = [], None, 0
    for r in records:
        if r["camera"] in st.view_of:
            out.append((st.view_of[r["camera"]], pending))
            pending = None
        elif r["camera"] in st.pseudo_of:
            if seen % 2 == 0:
                pending = st.pseudo_of[r["camera"]]
            seen += 1
    return out


def step_flops(st, view: int, pseudo) -> float:
    """A step's operations: ``train``'s for its view; a pseudo step adds
    its pseudo view's forward twice (the render for the prior, the render
    in the graph), that view's backward through the projection and the
    blend (its loss reads depth alone), and DPT_Hybrid at its input."""
    total = flops(st, view)
    if pseudo is not None:
        r, deg = work(st, pseudo), st.traced_map["sh_degree"]
        fwd = (r.projection_flops(False) + r.sh_flops(deg, False)
               + r.blend_fwd_flops())
        total += 2 * fwd + r.projection_flops(True) + r.blend_bwd_flops()
        total += workcount_dpt.count(*st.net_size).flops
    return total


def _gap(p, r) -> float:
    return float(abs(p - r) / abs(r))


def prior_gap(st, control=None) -> float:
    """The first prior the estimator returned against the plain network
    in float64 on the same colour (with ``control``, the plain network in
    that dtype in the program's place): the largest gap over the
    reference's largest value."""
    if st.prior_call is None:
        return float("inf")
    rgb, prog = st.prior_call
    dev = st.map.xyz.device

    def plain(dtype):
        sd = rdpt.weights(st.state_dict, dtype, dev)
        with torch.no_grad():
            return rdpt.estimate_depth(
                sd, torch.tensor(rgb, device=dev).to(dtype),
                st.net_size).double()

    rdpt.no_tf32()
    ref = plain(torch.float64)
    if control is not None:
        prog = plain(control).cpu().numpy()
    ref = ref.cpu().numpy()
    print(f"gsbench: prior over the frame: mean {ref.mean():.6g}, std "
          f"{ref.std():.6g}, min {ref.min():.6g}, max {ref.max():.6g}, "
          f"share at 0 {(ref <= 0).mean():.4f}", file=sys.stderr)
    return float(np.abs(prog - ref).max() / np.abs(ref).max())


def pseudo_numbers(st, control=None) -> dict:
    """The first pseudo step against the plain two-view step in float64:
    the main view's loss and the pseudo term by their relative gaps, the
    gradient by the worst group's gap (the norm of the difference over
    the larger of the group's reference norm and the median group's)."""
    p = st.pseudo
    if p is None:
        return {k: float("inf") for k in ("pseudo_loss_gap",
                                          "pseudo_term_gap",
                                          "pseudo_grad_gap")}
    from gs_localization_torch.mapping.train import TRAINABLE

    g = p["gaussians"]
    live = g.live
    prior = p["prior"]

    def plain(dtype):
        cam = st.cams[p["view"]]
        img, dep = st.images[p["view"]]
        dev = cam.w2c.device
        view = (cam.at(cam.w2c.to(dtype)),
                torch.tensor(img, device=dev).to(dtype),
                torch.tensor(dep, device=dev).to(dtype))
        pcam = st.cams[0].at(p["camera"].w2c.detach().to(dtype))
        params = {k: getattr(g, k)[live].to(dtype) for k in rtrain.GROUPS}
        return rfewshot.pseudo_step(params, view, pcam, prior.to(dtype),
                                    g.sh_degree, dataclasses.asdict(st.mcfg))

    ref = plain(torch.float64)
    if control is None:
        loss, term = float(p["loss"]), float(p["term"])
        grads = {k: gr[live] for k, gr in zip(TRAINABLE, p["grads"])}
    else:
        alt = plain(control)
        loss, term, grads = alt.loss, alt.pseudo, alt.grads
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref.grads.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k in rtrain.GROUPS if norms[k] >= 1e-3 * med]
    grad = max(float(torch.linalg.vector_norm(
        grads[k].double() - ref.grads[k].double())) / max(norms[k], med)
        for k in keep)
    return {"pseudo_loss_gap": _gap(loss, ref.loss),
            "pseudo_term_gap": _gap(term, ref.pseudo),
            "pseudo_grad_gap": grad}


def check(ctx, st, window, control=None) -> dict:
    out = base.check(ctx, st, window, control)
    nums = dict(pseudo_numbers(st, control), prior_gap=prior_gap(st, control))
    lim = ctx.limits
    out.update({k: {"value": v, "limit": lim[k]} for k, v in nums.items()})
    return out
