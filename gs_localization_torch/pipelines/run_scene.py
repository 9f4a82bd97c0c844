"""Scene runner CLI: the LoGS stages as one command, on the port.

  python -m gs_localization_torch.pipelines.run_scene \
      --scene /data/7scenes/chess --preset seven_scenes --stage all

Stages (the JAX package's ``run_scene``, same arguments, defaults and
files):
  prepare   : split layout (7-Scenes, Cambridge, LLFF / Mip-360)
  sfm       : the classical front end (Harris or SIFT features, mutual-NN
              matching, tiny-image retrieval): point model of the train
              images + PnP init poses -> out/results_dense.txt,
              out/sfm_points.npz
  train     : 3DGS map -> out/gs_map/iteration_N/point_cloud.ply
  localize  : pose refinement + median/recall metrics -> out/results.txt,
              out/metrics.json

``--device`` (default ``cuda``) picks the card or, with ``cpu``, the plain
PyTorch versions of the kernels. ``--weights-dir`` raises where it would
light up a network that is not ported (SuperPoint, SuperGlue and NetVLAD in
the sfm stage, SuperPoint keypoints in the localize stage, the MiDaS / DPT
depth prior in the train stage); checkpoints that are absent leave the
classical path. ``main`` returns each stage's result by stage name.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .. import resolve_device

# the checkpoints whose presence lights up a network in the JAX runner
_SUPERPOINT = "superpoint_v1.pth"
_SFM_NETWORKS = (_SUPERPOINT, "superglue_outdoor.pth", "Pitts30K_struct.mat")
_DEPTH_PRIORS = ("dpt_hybrid-midas-501f0c75.pt", "midas_v21-f6b98070.pt")


def stage_prepare(args):
    if args.preset == "cambridge":
        from ..data.prepare import prepare_cambridge

        train, test = prepare_cambridge(
            args.scene, depth_dir=args.depth_dir,
            size=tuple(args.prepare_size))
    elif args.preset in ("llff", "mip360"):
        from ..data.prepare import prepare_360, prepare_llff

        fn = prepare_llff if args.preset == "llff" else prepare_360
        train, test = fn(args.scene)
    else:
        from ..data.seven_scenes import prepare_scene

        train, test = prepare_scene(args.scene)
    print(f"prepared: {len(train)} train / {len(test)} test images")
    return train, test


def _load_scene(args):
    from ..data.scene import load_colmap_scene
    from ..data.seven_scenes import load_seven_scenes_scene

    dev = args.device
    if args.preset == "seven_scenes":
        return load_seven_scenes_scene(args.scene, model_dir=args.model_dir,
                                       device=dev)
    if args.preset in ("llff", "mip360"):
        from ..data.prepare import load_llff_scene

        return load_llff_scene(args.scene, device=dev)
    if args.preset == "cambridge":
        def read_list(fname):
            path = os.path.join(args.scene, fname)
            return [l.strip() for l in open(path) if l.strip()] \
                if os.path.exists(path) else None

        return load_colmap_scene(
            os.path.join(args.scene, "sparse/0"),
            images_dir=os.path.join(args.scene, args.images_dir),
            train_list=read_list("train_full.txt"),
            test_list=read_list("test_full.txt"),
            device=dev,
        )
    return load_colmap_scene(
        os.path.join(args.scene, args.model_dir),
        images_dir=os.path.join(args.scene, args.images_dir),
        eval_split=True, device=dev,
    )


def _build_frontend(args, cfg):
    """The sfm stage's extractor from ``--extractor``: None for Harris (the
    pipeline's default), else DoG + rootSIFT. A checkpoint in
    ``--weights-dir`` that would light up SuperPoint, SuperGlue or NetVLAD
    raises; absent files leave the classical front end."""
    _refuse_weights(args, _SFM_NETWORKS,
                    "the learned SfM front end (SuperPoint / SuperGlue / "
                    "NetVLAD)")
    if args.extractor != "sift":
        return None
    from ..sfm.features import rgb_to_gray
    from ..sfm.sift import extract_sift

    return lambda img: extract_sift(  # noqa: E731
        rgb_to_gray(img), num_keypoints=cfg.num_keypoints)


def stage_sfm(args):
    from ..data.scene import load_depth, load_image
    from ..sfm.io import write_pose_results
    from .sfm_init import SfmInitConfig, build_point_model, localize_query_pnp

    scene = _load_scene(args)
    cfg = SfmInitConfig()
    extractor = _build_frontend(args, cfg)
    imgs = [load_image(c.image_path) for c in scene.train_cameras]
    deps = None
    if args.use_depth:
        deps = [load_depth(c.depth_path) if c.depth_path and
                os.path.exists(c.depth_path) else
                np.zeros(imgs[i].shape[:2], np.float32)
                for i, c in enumerate(scene.train_cameras)]
    train_cams = [c.camera for c in scene.train_cameras]
    mapped = build_point_model(imgs, train_cams, cfg, depth_maps=deps,
                               extractor=extractor, device=args.device)
    poses = {}
    for q in scene.test_cameras:
        cam = q.camera
        K = np.array([[float(cam.fx), 0, float(cam.cx)],
                      [0, float(cam.fy), float(cam.cy)], [0, 0, 1.0]])
        qvec, tvec, info = localize_query_pnp(
            load_image(q.image_path), K, mapped, train_cams, cfg,
            extractor=extractor, device=args.device)
        poses[q.name] = (qvec, tvec)
        print(f"{q.name}: {info['method']} ({info.get('num_inliers', 0)} inl)")
    out = os.path.join(args.out, "results_dense.txt")
    os.makedirs(args.out, exist_ok=True)
    write_pose_results(out, poses)
    print(f"wrote {out}")
    # persist the triangulated cloud: scenes whose gt model carries no
    # points3D (cambridge/llff layouts) initialize the map from it
    valid = np.asarray(mapped.valid)
    pts = np.asarray(mapped.points)[valid]
    cols = np.asarray(mapped.track_colors)[valid]
    np.savez(os.path.join(args.out, "sfm_points.npz"),
             points=pts.astype(np.float32), colors=cols.astype(np.float32))
    print(f"saved {len(pts)} sfm points")
    return mapped, poses


def _refuse_weights(args, files, what: str) -> None:
    """Raise where ``--weights-dir`` holds a checkpoint that would light up
    a network the port does not have."""
    if not args.weights_dir:
        return
    found = [f for f in files
             if os.path.exists(os.path.join(args.weights_dir, f))]
    if found:
        raise NotImplementedError(
            f"--weights-dir holds {found}: {what} is not ported yet "
            "(ROADMAP.md §1 item 13, networks)")


def stage_train(args):
    from . import presets
    from .train_map import train_map
    from ..raster import RasterizerConfig

    _refuse_weights(args, _DEPTH_PRIORS,
                    "the monocular depth prior (pseudo views)")
    scene = _load_scene(args)
    sfm_pts = os.path.join(args.out, "sfm_points.npz")
    if scene.points.shape[0] == 0 and os.path.exists(sfm_pts):
        d = np.load(sfm_pts)
        scene.points = d["points"]
        scene.colors = d["colors"]
        print(f"initialized from {len(d['points'])} sfm points")
    tcfg = {"cambridge": presets.cambridge_training,
            "llff": presets.mip360_training,
            "mip360": presets.mip360_training}.get(
        args.preset, presets.seven_scenes_training)()
    if args.iterations:
        tcfg.iterations = args.iterations
        tcfg.test_iterations = (args.iterations,)
        tcfg.save_iterations = (args.iterations,)
        # keep the reference's schedule shape on short runs: densify for
        # the first half (15k of 30k), so a short run does not densify to
        # its very end
        if args.iterations < 2 * tcfg.densify_until:
            tcfg.densify_until = args.iterations // 2
        # the same for the few-shot pseudo-view window ((2k, 29k) of 30k)
        if args.iterations < tcfg.end_sample_pseudo:
            frac = args.iterations / 30_000
            tcfg.start_sample_pseudo = max(1, int(2_000 * frac))
            tcfg.end_sample_pseudo = max(2, int(29_000 * frac))
    mcfg = {"cambridge": presets.cambridge_map_cfg,
            "llff": presets.mip360_map_cfg,
            "mip360": presets.mip360_map_cfg}.get(
        args.preset, presets.seven_scenes_map_cfg)(scene.extent)
    rcfg = RasterizerConfig(max_pairs=args.max_pairs,
                            max_per_tile=args.max_per_tile,
                            use_stream=args.stream)
    return train_map(scene, args.out, tcfg, mcfg, rcfg, device=args.device)


def stage_localize(args):
    import torch

    from . import presets
    from .localize import QuerySpec, load_map, localize_queries
    from ..core.camera import rotmat_to_quat, w2c_from_quat_t
    from ..data.scene import load_depth, load_image
    from ..raster import RasterizerConfig
    from ..sfm.io import read_pose_results, write_pose_results

    _refuse_weights(args, (_SUPERPOINT,), "SuperPoint (keypoint masks)")
    scene = _load_scene(args)
    map_path = args.map or os.path.join(
        args.out, f"gs_map/iteration_{args.iterations or 30000}",
        "point_cloud.ply")
    gaussians = load_map(map_path, device=args.device)
    init = read_pose_results(os.path.join(args.out, "results_dense.txt"))
    lcfg = {"cambridge": presets.cambridge_localize,
            "llff": presets.mip360_localize,
            "mip360": presets.mip360_localize}.get(
        args.preset, presets.seven_scenes_localize)()
    rcfg = RasterizerConfig(max_pairs=args.max_pairs,
                            max_per_tile=args.max_per_tile,
                            use_stream=args.stream)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=args.device)

    queries = []
    for q in scene.test_cameras:
        if q.name not in init:
            continue
        qv, tv = init[q.name]
        cam = q.camera.replace(w2c=w2c_from_quat_t(f32(qv), f32(tv)))
        img = load_image(q.image_path)
        dep = None
        if not lcfg.tracking.monocular and q.depth_path and \
                os.path.exists(q.depth_path):
            dep = load_depth(q.depth_path)
        queries.append(QuerySpec(
            name=q.name, camera=cam, image=img, depth=dep, keypoints=None,
            gt_w2c=q.camera.w2c.cpu().numpy(),
        ))
    results, metrics = localize_queries(gaussians, queries, lcfg, rcfg)
    os.makedirs(args.out, exist_ok=True)
    poses = {}
    for name, w2c in results.items():
        poses[name] = (rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3])
    write_pose_results(os.path.join(args.out, "results.txt"), poses)
    if metrics:
        with open(os.path.join(args.out, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        print(json.dumps(metrics, indent=2))
    return results, metrics


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--stage", default="all",
                    choices=["prepare", "sfm", "train", "localize", "all"])
    ap.add_argument("--preset", default="seven_scenes",
                    choices=["seven_scenes", "cambridge", "llff", "mip360",
                             "colmap"])
    ap.add_argument("--depth-dir", default=None,
                    help="Cambridge_additional-style depth tree for prepare")
    ap.add_argument("--prepare-size", type=int, nargs=2,
                    default=(1024, 576),
                    help="cambridge prepare resize WxH (reference: 1024 576)")
    ap.add_argument("--model-dir", default="sparse_dslam/0")
    ap.add_argument("--images-dir", default="images_full")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--map", default=None)
    ap.add_argument("--use-depth", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="default: on for seven_scenes (RGB-D), off for "
                         "the monocular presets (cambridge/llff/mip360); "
                         "read by the sfm stage")
    ap.add_argument("--max-pairs", type=int, default=1 << 21)
    ap.add_argument("--stream", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the pair-stream layout (K1/K2, default); "
                         "--no-stream takes the pregathered windows (K3/K4)")
    ap.add_argument("--max-per-tile", type=int, default=1024)
    ap.add_argument("--extractor", default="harris",
                    choices=("harris", "sift"),
                    help="SfM front-end features (sift = DoG+rootSIFT; "
                         "read by the sfm stage)")
    ap.add_argument("--weights-dir", default=None,
                    help="directory of official checkpoints (WEIGHTS.md); "
                         "the networks they enable are not ported yet, so "
                         "a checkpoint a stage would use raises, and "
                         "absent files leave the classical front end")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(args.scene, "output_tpu")
    if args.use_depth is None:
        args.use_depth = args.preset == "seven_scenes"
    args.device = resolve_device(args.device)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    stages = ([args.stage] if args.stage != "all"
              else ["prepare", "sfm", "train", "localize"])
    done = {}
    for s in stages:
        print(f"=== stage: {s} ===")
        done[s] = {"prepare": stage_prepare, "sfm": stage_sfm,
                   "train": stage_train, "localize": stage_localize}[s](args)
    return done


if __name__ == "__main__":
    main()
