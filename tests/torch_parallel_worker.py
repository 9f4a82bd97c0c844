"""One rank of a gloo world for tests/test_torch_parallel.py (no JAX).

    python tests/torch_parallel_worker.py --rank R --world N --init ADDR --out DIR

Runs every case of the port's sharded functions on the CPU at this world
size, with one intra-op thread, and writes this rank's results to
``DIR/w{N}_r{R}.npz``; rank 0 also writes the port's unsharded results of
the same cases. The inputs are numpy draws from fixed seeds, which the test
hands to the JAX package too (``scene_arrays``, ``camera_taus``,
``target_images``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAINABLE = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
             "opacity")
# the JAX tests' capacities (tests/test_parallel.py); the port bins the
# same (T, 64) id matrix (use_stream=False) and runs the plain K3/K4
RASTER = dict(max_pairs=1 << 13, max_per_tile=64, chunk=32)
PORT_RASTER = dict(RASTER, pallas_chunk=64, use_stream=False)
TRACK = dict(num_iters=5, lr=2e-3)
# case -> (scene seed, n, spread, scale range, image W, H)
SCENES = {
    "dp": (10, 100, 1.0, (-3.5, -2.0), 32, 32),
    "refine": (11, 200, 1.5, (-3.0, -1.8), 48, 32),
    "tile": (12, 150, 1.0, (-3.5, -2.0), 128, 64),
    "gauss": (13, 160, 1.0, (-3.5, -2.0), 48, 32),
    "gauss2d": (14, 120, 1.0, (-3.5, -2.0), 32, 32),
}
CAMS_PER_RANK = 2          # dp: 2 cameras per rank; refine: 1 query
N_2D = 4                   # gauss2d: 4 cameras on a (data 2, gauss 2) mesh


def scene_arrays(case: str) -> dict:
    """tests/helpers.py::random_scene's draws at SH degree 1."""
    seed, n, spread, scale_range, _, _ = SCENES[case]
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-spread, spread, n),
                    rng.uniform(-spread, spread, n),
                    rng.uniform(2.0, 6.0, n)], axis=1).astype(np.float32)
    c0 = 0.28209479177387814
    fdc = ((rng.uniform(0.05, 0.95, (n, 3)) - 0.5) / c0).astype(
        np.float32)[:, None, :]
    frest = (0.1 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    scaling = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    rotation = rng.standard_normal((n, 4)).astype(np.float32)
    rotation /= np.linalg.norm(rotation, axis=1, keepdims=True)
    opacity = rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)
    return dict(xyz=xyz, features_dc=fdc, features_rest=frest,
                scaling=scaling, rotation=rotation, opacity=opacity)


def camera_taus(case: str, n: int) -> np.ndarray:
    scale = 0.01 if case == "refine" else 0.02
    rng = np.random.default_rng(100 + SCENES[case][0])
    return (scale * rng.standard_normal((n, 6))).astype(np.float32)


def target_images(case: str, n: int) -> np.ndarray:
    _, _, _, _, w, h = SCENES[case]
    rng = np.random.default_rng(200 + SCENES[case][0])
    return rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)


def focal(case: str) -> float:
    w = SCENES[case][4]
    return w / (2.0 * np.tan(0.5))


def run(rank: int, world: int, init: str, out: str) -> None:
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from gs_localization_torch.core.camera import Camera
    from gs_localization_torch.core.gaussians import GaussianParams
    from gs_localization_torch.loc import TrackingConfig, refine_poses_batch
    from gs_localization_torch.mapping import losses
    from gs_localization_torch.parallel import dp, gauss_shard, runtime
    from gs_localization_torch.parallel.tile_shard import (
        rasterize_tile_sharded)
    from gs_localization_torch.raster import RasterizerConfig, rasterize

    assert runtime.initialize_runtime(init, world, rank, backend="gloo")
    cfg = RasterizerConfig(**PORT_RASTER)
    res, ref = {}, {}

    def scene(case):
        return GaussianParams.from_arrays(**scene_arrays(case), sh_degree=1,
                                          device="cpu")

    def cameras(case, n):
        _, _, _, _, w, h = SCENES[case]
        f = focal(case)
        base = Camera.from_rt(np.eye(3), np.zeros(3), f, f, w, h,
                              device="cpu")
        return base, [base.with_delta(torch.tensor(t))
                      for t in camera_taus(case, n)]

    def mean_grads(g, cams, imgs):
        """The unsharded reference: the mean loss and gradients."""
        ls, gs = [], []
        for c, im in zip(cams, imgs):
            p = {k: getattr(g, k).detach().requires_grad_() for k in TRAINABLE}
            o = rasterize(g.replace(**p), c, cfg)
            loss = losses.training_loss(o.color, im)[0]
            ls.append(float(loss))
            gs.append(torch.autograd.grad(loss, [p[k] for k in TRAINABLE]))
        return np.mean(ls), {k: torch.stack([x[i] for x in gs]).mean(0)
                             .numpy() for i, k in enumerate(TRAINABLE)}

    # ---- dp_train_grads --------------------------------------------------
    mesh = dp.make_mesh(world)
    g = scene("dp")
    n = world * CAMS_PER_RANK
    _, cams = cameras("dp", n)
    imgs = torch.tensor(target_images("dp", n))
    lo, hi = runtime.host_local_slice(n, mesh)
    loss, grads = dp.dp_train_grads(mesh, g, cams[lo:hi], imgs[lo:hi], cfg)
    res["dp/loss"] = float(loss)
    res.update({f"dp/{k}": v.numpy() for k, v in grads.items()})
    if rank == 0:
        rl, rg = mean_grads(g, cams, imgs)
        ref["dp/loss"] = rl
        ref.update({f"dp/{k}": v for k, v in rg.items()})

    # ---- shard_queries_refine -------------------------------------------
    g = scene("refine")
    base, cams = cameras("refine", world)
    with torch.no_grad():
        target = rasterize(g, base, cfg)
    imgs = target.color[None].repeat(world, 1, 1, 1)
    deps = target.depth[None].repeat(world, 1, 1)
    masks = torch.ones(imgs.shape[:3], dtype=torch.bool)
    tcfg = TrackingConfig(**TRACK)
    lo, hi = runtime.host_local_slice(world, mesh)
    r = dp.shard_queries_refine(mesh, g, cams[lo:hi], imgs[lo:hi],
                                masks[lo:hi], tcfg, cfg, gt_depths=deps[lo:hi])
    res["refine/w2c"] = r.w2c.numpy()
    res["refine/num_iters"] = np.asarray(r.num_iters)
    if rank == 0:
        rr = refine_poses_batch(g, cams, imgs, masks, tcfg, cfg,
                                gt_depths=deps)
        ref["refine/w2c"] = rr.w2c.numpy()
        ref["refine/num_iters"] = np.asarray(rr.num_iters)

    # ---- rasterize_tile_sharded: forward, gradients in Gaussians and tau --
    tmesh = dp.make_mesh(world, axis="tile")
    g = scene("tile")
    base, _ = cameras("tile", 0)

    def tile_loss(render):
        p = {k: getattr(g, k).detach().requires_grad_() for k in TRAINABLE}
        tau = torch.zeros(6, requires_grad=True)
        o = render(g.replace(**p), base.with_delta(tau))
        loss = (o.color ** 2).sum() + 0.1 * (o.depth ** 2).sum()
        gr = torch.autograd.grad(loss, [p[k] for k in TRAINABLE] + [tau])
        return o, gr

    o, gr = tile_loss(lambda gg, c: rasterize_tile_sharded(tmesh, gg, c, cfg))
    res["tile/color"], res["tile/depth"] = o.color.detach().numpy(), \
        o.depth.detach().numpy()
    res.update({f"tile/d_{k}": v.numpy()
                for k, v in zip(TRAINABLE + ("tau",), gr)})
    if rank == 0:
        o, gr = tile_loss(lambda gg, c: rasterize(gg, c, cfg))
        ref["tile/color"], ref["tile/depth"] = o.color.detach().numpy(), \
            o.depth.detach().numpy()
        ref.update({f"tile/d_{k}": v.numpy()
                    for k, v in zip(TRAINABLE + ("tau",), gr)})

    # ---- rasterize_gauss_sharded ----------------------------------------
    gmesh = dp.make_mesh(world, axis="gauss")
    g = scene("gauss")
    base, _ = cameras("gauss", 0)
    with torch.no_grad():
        color, depth, alpha, radii = gauss_shard.rasterize_gauss_sharded(
            gmesh, gauss_shard.shard_rows(g, gmesh), base, cfg)
        res.update({"gauss/color": color.numpy(), "gauss/depth": depth.numpy(),
                    "gauss/alpha": alpha.numpy(), "gauss/radii": radii.numpy()})
        if rank == 0:
            o = rasterize(g, base, cfg)
            ref.update({"gauss/color": o.color.numpy(),
                        "gauss/depth": o.depth.numpy(),
                        "gauss/alpha": o.alpha.numpy(),
                        "gauss/radii": o.radii.numpy()})

    # ---- gauss_sharded_loss_and_grads on a (data 2, gauss 2) mesh --------
    if world == 4:
        mesh2 = gauss_shard.make_mesh_2d(2, 2)
        g = scene("gauss2d")
        _, cams = cameras("gauss2d", N_2D)
        imgs = torch.tensor(target_images("gauss2d", N_2D))
        lo, hi = runtime.host_local_slice(N_2D, mesh2, axis="data")
        loss, grads = gauss_shard.gauss_sharded_loss_and_grads(
            mesh2, gauss_shard.shard_rows(g, mesh2), cams[lo:hi],
            imgs[lo:hi], cfg)
        res["gauss2d/loss"] = float(loss)
        res.update({f"gauss2d/{k}": v.numpy() for k, v in grads.items()})
        res["gauss2d/coords"] = np.asarray([mesh2.index("data"),
                                            mesh2.index("gauss")])
        if rank == 0:
            rl, rg = mean_grads(g, cams, imgs)
            ref["gauss2d/loss"] = rl
            ref.update({f"gauss2d/{k}": v for k, v in rg.items()})

    np.savez(os.path.join(out, f"w{world}_r{rank}.npz"), **res)
    if rank == 0:
        np.savez(os.path.join(out, f"w{world}_ref.npz"), **ref)
    runtime.shutdown_runtime()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    run(a.rank, a.world, a.init, a.out)
