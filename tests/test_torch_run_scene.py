"""The port's scene runner (``run_scene``) against the JAX package's.

With ``train_map`` / ``load_map`` / ``localize_queries`` replaced in both
packages by recorders, the train and localize stages of each runner read
the same 7-Scenes-shaped layout and must hand over the same configs, scene
cameras and ``QuerySpec``s (seven_scenes and cambridge presets, with and
without ``--iterations``). Then one tiny end-to-end CPU run of the port's
CLI: prepare -> train 10 iterations -> localize 5 iterations at 64x48.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import gs_localization_tpu.pipelines as jpipes
from gs_localization_tpu.pipelines import localize as jloc
from gs_localization_tpu.pipelines import run_scene as jrun
from gs_localization_tpu.utils import profiling as jprof
import gs_localization_torch as gsl
from gs_localization_torch.core import sh as sh_lib
from gs_localization_torch.core.camera import rotmat_to_quat
from gs_localization_torch.data.colmap import (
    ColmapCamera, ColmapImage, write_colmap_model_text)
from gs_localization_torch.data.ply import load_gaussian_ply
from gs_localization_torch.pipelines import localize as tloc
from gs_localization_torch.pipelines import presets as tpresets
from gs_localization_torch.pipelines import run_scene as trun
from gs_localization_torch.pipelines import train_map as ttm
from gs_localization_torch.raster import RasterizerConfig, rasterize
from gs_localization_torch.sfm.io import read_pose_results, write_pose_results
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch, np_of

W, H = 64, 48
N_TRAIN, N_TEST = 6, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: its loops run many small CPU
    ops, and when each spreads over a thread pool, the suite's parallel
    workers (more threads than cores) make every op wait on a barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_frame(d, i, color, depth) -> None:
    from PIL import Image

    Image.fromarray((np.clip(color, 0, 1) * 255).astype(np.uint8)).save(
        d / f"frame-{i:06d}.color.png")
    Image.fromarray(np.round(depth * 1000).astype(np.uint16)).save(
        d / f"frame-{i:06d}.depth.png")


def _write_scene(root, rng, width, height):
    """A raw 7-Scenes layout rendered by the port on the CPU (N_TRAIN
    training frames in seq-01, N_TEST test frames in seq-02, colour and
    16-bit mm depth PNGs, the splits, a ``sparse_dslam/0`` model of the
    true poses). Returns (world, cameras, flat image names)."""
    world = gaussians_to_torch(random_scene(
        rng, n=250, sh_degree=1, spread=1.4, z_range=(2.5, 5.0),
        scale_range=(-3.4, -2.4)))
    cfg = RasterizerConfig(max_pairs=1 << 14, pallas_chunk=64)
    base = camera_to_torch(make_camera(width, height, fov=1.0))
    cams, names, images = [], [], {}
    for i in range(N_TRAIN + N_TEST):
        tau = np.concatenate([0.05 * rng.standard_normal(3),
                              0.02 * rng.standard_normal(3)])
        cam = base.with_delta(torch.tensor(tau, dtype=torch.float32))
        seq, k = ("seq-01", i) if i < N_TRAIN else ("seq-02", i - N_TRAIN)
        (root / seq).mkdir(parents=True, exist_ok=True)
        with torch.no_grad():
            out = rasterize(world, cam, cfg)
        _write_frame(root / seq, k, np_of(out.color), np_of(out.depth))
        w2c = np_of(cam.w2c).astype(np.float64)
        name = f"{seq}-frame-{k:06d}-color.png"
        images[i + 1] = ColmapImage(i + 1, rotmat_to_quat(w2c[:3, :3]),
                                    w2c[:3, 3], 1, name, np.zeros((0, 2)),
                                    np.zeros((0,), np.int64))
        cams.append(cam)
        names.append(name)
    (root / "TrainSplit.txt").write_text("sequence1\n")
    (root / "TestSplit.txt").write_text("sequence2\n")
    c0 = cams[0]
    colmap_cams = {1: ColmapCamera(1, "PINHOLE", width, height, np.array(
        [float(c0.fx), float(c0.fy), float(c0.cx), float(c0.cy)]))}
    write_colmap_model_text(str(root / "sparse_dslam" / "0"), colmap_cams,
                            images, {})
    return world, cams, names


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The 7-Scenes layout of ``_write_scene`` at 64x48, the sfm stage's
    two files in ``output_tpu`` (the world's means and colours, the test
    poses moved by a few cm), and ``sparse/0`` for the cambridge preset."""
    root = tmp_path_factory.mktemp("seven") / "chess"
    rng = np.random.default_rng(12)
    world, cams, names = _write_scene(root, rng, W, H)
    shutil.copytree(root / "sparse_dslam" / "0", root / "sparse" / "0")
    out = root / "output_tpu"
    out.mkdir()
    colors = np.clip(sh_lib.sh_dc_to_rgb(np_of(world.features_dc[:, 0])),
                     0, 1)
    np.savez(out / "sfm_points.npz", points=np_of(world.xyz),
             colors=colors.astype(np.float32))
    init = {}
    for cam, name in zip(cams[N_TRAIN:], names[N_TRAIN:]):
        tau = np.concatenate([0.02 * rng.standard_normal(3),
                              0.01 * rng.standard_normal(3)])
        w2c = np_of(cam.with_delta(torch.tensor(
            tau, dtype=torch.float32)).w2c).astype(np.float64)
        init[name] = (rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3])
    write_pose_results(str(out / "results_dense.txt"), init)
    trun.main(["--scene", str(root), "--stage", "prepare", "--device",
               "cpu"])
    return root, names


@pytest.fixture(scope="module")
def sift_layout(tmp_path_factory):
    """The layout of ``_write_scene`` at 96x72, prepared: SIFT's third
    octave (24x18) must hold its 341 candidates per octave."""
    root = tmp_path_factory.mktemp("seven_sift") / "chess"
    _write_scene(root, np.random.default_rng(13), 96, 72)
    trun.main(["--scene", str(root), "--stage", "prepare", "--device",
               "cpu"])
    return root


class _Recorder:
    """Stands in for train_map / load_map / localize_queries."""

    def __init__(self):
        self.calls = {}

    def train_map(self, scene, out, tcfg, mcfg, rcfg, **kw):
        self.calls["train"] = (scene, out, tcfg, mcfg, rcfg, kw)

    def load_map(self, path, **kw):
        self.calls["map"] = path
        return "map"

    def localize_queries(self, g, queries, lcfg, rcfg, **kw):
        self.calls["localize"] = (g, queries, lcfg, rcfg)
        return {q.name: np.asarray(q.gt_w2c) for q in queries}, None


def _run_both(monkeypatch, argv):
    """Each package's runner on argv with the recorders in place."""
    jr, tr = _Recorder(), _Recorder()
    monkeypatch.setattr(jprof, "enable_persistent_compile_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(jpipes, "train_map", jr.train_map)
    monkeypatch.setattr(jloc, "load_map", jr.load_map)
    monkeypatch.setattr(jloc, "localize_queries", jr.localize_queries)
    monkeypatch.setattr(ttm, "train_map", tr.train_map)
    monkeypatch.setattr(tloc, "load_map", tr.load_map)
    monkeypatch.setattr(tloc, "localize_queries", tr.localize_queries)
    jrun.main(argv)
    trun.main(argv + ["--device", "cpu"])
    return jr.calls, tr.calls


def _same_fields(a, b, skip=()) -> None:
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    common = (set(fa) & set(fb)) - set(skip)
    assert common, (a, b)
    for k in sorted(common):
        if dataclasses.is_dataclass(fa[k]):
            _same_fields(fa[k], fb[k])
        else:
            assert fa[k] == fb[k], (k, fa[k], fb[k])


def _same_camera(cj, ct) -> None:
    assert (cj.width, cj.height) == (ct.width, ct.height)
    for f in ("w2c", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(np_of(getattr(ct, f)),
                                   np_of(getattr(cj, f)), atol=1e-6,
                                   err_msg=f)


CASES = [("seven_scenes", None), ("seven_scenes", 300), ("cambridge", 2500)]


@pytest.mark.parametrize("preset,iterations", CASES)
def test_stage_train_hands_over_what_jax_does(layout, monkeypatch, preset,
                                              iterations):
    root, _ = layout
    argv = ["--scene", str(root), "--preset", preset, "--stage", "train",
            "--max-pairs", "65536"]
    if iterations:
        argv += ["--iterations", str(iterations)]
    jc, tc = _run_both(monkeypatch, argv)
    (sj, oj, tj, mj, rj, kj), (st, ot, tt, mt, rt, kt) = jc["train"], \
        tc["train"]
    assert oj == ot == str(root / "output_tpu")
    _same_fields(tj, tt)
    _same_fields(mj, mt)
    _same_fields(rj, rt)
    assert rt.use_stream and rt.max_pairs == 65536
    assert kj == {"depth_estimator": None}
    assert kt == {"device": torch.device("cpu")}
    for cj, ct in ((sj.train_cameras, st.train_cameras),
                   (sj.test_cameras, st.test_cameras)):
        assert [c.name for c in cj] == [c.name for c in ct]
        assert [c.image_path for c in cj] == [c.image_path for c in ct]
        assert [c.depth_path for c in cj] == [c.depth_path for c in ct]
        for a, b in zip(cj, ct):
            _same_camera(a.camera, b.camera)
    assert len(st.train_cameras) == N_TRAIN and len(st.test_cameras) == \
        N_TEST
    np.testing.assert_array_equal(st.points, sj.points)
    np.testing.assert_array_equal(st.colors, sj.colors)
    np.testing.assert_allclose(st.extent, sj.extent, rtol=1e-6)
    if iterations == 300:
        assert (tt.densify_until, tt.start_sample_pseudo,
                tt.end_sample_pseudo) == (150, 20, 290)


@pytest.mark.parametrize("iterations,window", [
    (300, (20, 290)), (2_500, (166, 2_416)), (28_000, (1_866, 27_066)),
    (30_000, (2_000, 29_000)), (40_000, (2_000, 29_000))])
def test_stage_train_scales_the_pseudo_window(layout, monkeypatch,
                                              iterations, window):
    """The few-shot pseudo-view window ((2k, 29k) of 30k) handed to
    train_map is scaled to a shorter run, and still holds pseudo steps."""
    root, _ = layout
    rec = _Recorder()
    monkeypatch.setattr(ttm, "train_map", rec.train_map)
    trun.main(["--scene", str(root), "--stage", "train", "--iterations",
               str(iterations), "--device", "cpu"])
    tcfg = rec.calls["train"][2]
    assert (tcfg.start_sample_pseudo, tcfg.end_sample_pseudo) == window
    assert (tcfg.sample_pseudo_interval, tcfg.pseudo_per_edge,
            tcfg.fewshot_threshold) == (20, 3, 200)
    steps = [it for it in range(1, iterations + 1)
             if it % 20 == 0 and window[0] < it < window[1]]
    assert len(steps) == (window[1] - 1) // 20 - window[0] // 20 > 0


@pytest.mark.parametrize("preset,iterations", CASES)
def test_stage_localize_hands_over_what_jax_does(layout, monkeypatch,
                                                 preset, iterations):
    root, names = layout
    argv = ["--scene", str(root), "--preset", preset, "--stage",
            "localize"]
    if iterations:
        argv += ["--iterations", str(iterations)]
    jc, tc = _run_both(monkeypatch, argv)
    assert jc["map"] == tc["map"] == os.path.join(
        str(root / "output_tpu"),
        f"gs_map/iteration_{iterations or 30000}", "point_cloud.ply")
    (_, qj, lj, rj), (_, qt, lt, rt) = jc["localize"], tc["localize"]
    _same_fields(lj, lt)
    _same_fields(rj, rt)
    assert [q.name for q in qt] == [q.name for q in qj] == names[N_TRAIN:]
    for a, b in zip(qj, qt):
        _same_camera(a.camera, b.camera)
        np.testing.assert_array_equal(b.image, a.image)
        if preset == "seven_scenes":
            np.testing.assert_array_equal(b.depth, a.depth)
            assert b.depth.max() > 0
        else:                                    # monocular: no depth
            assert a.depth is None and b.depth is None
        assert a.keypoints is None and b.keypoints is None
        np.testing.assert_allclose(b.gt_w2c, np.asarray(a.gt_w2c),
                                   atol=1e-6)
    back = read_pose_results(str(root / "output_tpu" / "results.txt"))
    assert list(back) == names[N_TRAIN:]


@pytest.mark.parametrize("extractor", ["harris", "sift"])
def test_stage_sfm_writes_what_jax_does(layout, sift_layout, monkeypatch,
                                        tmp_path, capsys, extractor):
    """The sfm stage of both runners on the same files: the same printed
    lines, the same query names and methods, init poses within 1e-5 and
    the saved point cloud within 1e-4."""
    root = layout[0] if extractor == "harris" else sift_layout
    monkeypatch.setattr(jprof, "enable_persistent_compile_cache",
                        lambda *a, **k: None)
    argv = ["--scene", str(root), "--stage", "sfm", "--extractor",
            extractor]
    jrun.main(argv + ["--out", str(tmp_path / "jax")])
    log_j = capsys.readouterr().out
    done = trun.main(argv + ["--out", str(tmp_path / "port"), "--device",
                             "cpu"])
    log_t = capsys.readouterr().out
    assert log_t.replace("/port/", "/jax/") == log_j
    assert "pnp" in log_t
    pj = read_pose_results(str(tmp_path / "jax" / "results_dense.txt"))
    pt = read_pose_results(str(tmp_path / "port" / "results_dense.txt"))
    assert list(pt) == list(pj) == [c.name for c in trun._load_scene(
        trun.parse_args(argv + ["--device", "cpu"])).test_cameras]
    for name in pj:
        for a, b in zip(pt[name], pj[name]):
            np.testing.assert_allclose(a, b, atol=1e-5)
    cj = np.load(tmp_path / "jax" / "sfm_points.npz")
    ct = np.load(tmp_path / "port" / "sfm_points.npz")
    assert len(ct["points"]) == len(cj["points"]) > 0
    np.testing.assert_allclose(ct["points"], cj["points"], atol=1e-4)
    np.testing.assert_allclose(ct["colors"], cj["colors"], atol=1e-6)
    mapped, poses = done["sfm"]
    assert int(mapped.valid.sum()) == len(ct["points"])
    assert list(poses) == list(pt)


def test_sfm_stage_and_weights_are_refused(layout, tmp_path):
    """A checkpoint that would light up a network that is not ported
    raises at the stage that would use it; an empty --weights-dir leaves
    the classical front end."""
    root, _ = layout
    empty = tmp_path / "empty"
    empty.mkdir()
    done = trun.main(["--scene", str(root), "--stage", "sfm", "--device",
                      "cpu", "--weights-dir", str(empty), "--out",
                      str(tmp_path / "out")])
    assert len(done["sfm"][1]) == N_TEST
    (tmp_path / "midas_v21-f6b98070.pt").write_bytes(b"")
    (tmp_path / "superpoint_v1.pth").write_bytes(b"")
    for stage, what in (("train", "depth prior"), ("localize",
                                                   "SuperPoint"),
                        ("sfm", "SuperPoint / SuperGlue / NetVLAD")):
        with pytest.raises(NotImplementedError, match=what):
            trun.main(["--scene", str(root), "--stage", stage, "--device",
                       "cpu", "--weights-dir", str(tmp_path)])


def test_cli_end_to_end_on_the_cpu(layout, monkeypatch, capsys):
    """prepare -> train (stream layout, 10 iterations) -> localize (5
    iterations a query) through ``main``, on the CPU: the files of the
    runner's contract, poses that read back, and no kernel launch. Then
    ``--stage all`` (prepare -> sfm -> train -> localize) into an empty
    ``--out``: the sfm stage writes the files the later stages read."""
    root, names = layout
    out = root / "e2e"
    out.mkdir()
    for f in ("sfm_points.npz", "results_dense.txt"):
        shutil.copy(root / "output_tpu" / f, out / f)
    five = dataclasses.replace(tpresets.seven_scenes_tracking(),
                               num_iters=5)
    monkeypatch.setattr(tpresets, "seven_scenes_tracking", lambda: five)
    gsl.reset_launches()
    common = ["--scene", str(root), "--out", str(out), "--device", "cpu",
              "--max-pairs", "16384"]
    done = trun.main(common + ["--stage", "prepare"])
    assert [len(s) for s in done["prepare"]] == [N_TRAIN, N_TEST]
    done = trun.main(common + ["--stage", "train", "--iterations", "10"])
    log = capsys.readouterr().out
    assert f"initialized from 250 sfm points" in log
    assert "[10] test PSNR" in log
    ply = out / "gs_map" / "iteration_10" / "point_cloud.ply"
    g = load_gaussian_ply(str(ply), device="cpu")
    assert g.capacity == int(done["train"].num_live) and g.capacity > 0
    done = trun.main(common + ["--stage", "localize", "--iterations", "10"])
    results, metrics = done["localize"]
    back = read_pose_results(str(out / "results.txt"))
    assert list(back) == names[N_TRAIN:]
    for name, (q, t) in back.items():
        assert np.isfinite(q).all() and np.isfinite(t).all()
        np.testing.assert_allclose(results[name][:3, 3], t, atol=1e-6)
    with open(out / "metrics.json") as f:
        assert json.load(f) == metrics
    assert metrics["median_trans_m"] < 0.2
    assert all(v == 0 for v in gsl.LAUNCHES.values())

    out_all = root / "e2e_all"
    common[3] = str(out_all)
    done = trun.main(common + ["--stage", "all", "--iterations", "10"])
    log = capsys.readouterr().out
    assert list(done) == ["prepare", "sfm", "train", "localize"]
    mapped, poses = done["sfm"]
    n_pts = int(mapped.valid.sum())
    assert n_pts > 0 and list(poses) == names[N_TRAIN:]
    assert f"initialized from {n_pts} sfm points" in log
    assert list(read_pose_results(str(out_all / "results.txt"))) == \
        names[N_TRAIN:]
    assert (out_all / "metrics.json").exists()
    assert all(v == 0 for v in gsl.LAUNCHES.values())
