"""The PyTorch port stands alone: no JAX import, CPU-importable, and entry
points that refuse to run without CUDA unless asked for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import gs_localization_torch as gsl
from gs_localization_torch import _kernels
from gs_localization_torch.core.camera import Camera
from gs_localization_torch.core.gaussians import GaussianParams
from gs_localization_torch.pipelines.localize import (
    LocalizePipelineConfig, build_mask)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gs_localization_tpu")
# the card tests and their helper run where JAX is not installed
PORT_FILES = sorted((ROOT / "gs_localization_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "blend_edges.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"stream_blend.py", "refine.py", "localize.py", "pallas_blend.py",
            "train.py", "densify.py", "train_map.py", "knn.py", "ssim.py",
            "scene.py", "chip_smoke.py", "run_scene.py", "presets.py",
            "colmap.py", "seven_scenes.py", "prepare.py", "io.py",
            "oracle.py", "checkpoint.py", "lpips.py",
            "render_eval.py", "pseudo_views.py", "rgbd.py", "undistort.py",
            "blender.py", "colmap_db.py", "native_loader.py", "config.py",
            "logging.py", "profiling.py", "viewer.py", "features.py",
            "sift.py", "matching.py", "retrieval.py", "pairs.py",
            "triangulate.py", "pnp.py", "bundle_adjust.py", "incremental.py",
            "adalam.py", "match_dense.py", "evaluate.py",
            "sfm_init.py", "lightglue.py", "loftr.py", "d2net.py",
            "r2d2.py", "disk.py", "dir.py", "openibl.py",
            "eigenplaces.py", "viz.py", "runtime.py", "dp.py",
            "tile_shard.py", "gauss_shard.py", "dryrun.py"} <= names


def test_parallel_and_viz_import_without_jax_or_matplotlib():
    """``gs_localization_torch.parallel.*`` and ``sfm.viz`` import in a
    fresh process without JAX; the package and every module but
    ``sfm.viz`` import without matplotlib, which the card machine does not
    have."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gs_localization_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'gs_localization_torch.'):\n"
        "    if m.name != 'gs_localization_torch.sfm.viz':\n"
        "        importlib.import_module(m.name)\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "from gs_localization_torch.parallel import (dp, dryrun, gauss_shard,\n"
        "                                            runtime, tile_shard)\n"
        "from gs_localization_torch.sfm import viz\n"
        "assert 'matplotlib' in sys.modules\n"
        "assert not any(n.split('.')[0] in ('jax', 'jaxlib', "
        "'gs_localization_tpu') for n in sys.modules), 'jax imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_imports_without_nvcc_or_triton(tmp_path):
    """Every module imports in a fresh process whose PATH holds no nvcc,
    and importing builds nothing and pulls in no triton."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gs_localization_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'gs_localization_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from gs_localization_torch import _kernels\n"
        "assert _kernels._LIB is None\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _arrays(n=4):
    return {"xyz": np.zeros((n, 3)), "features_dc": np.zeros((n, 1, 3)),
            "features_rest": np.zeros((n, 0, 3)), "scaling": np.zeros((n, 3)),
            "rotation": np.tile([1.0, 0, 0, 0], (n, 1)),
            "opacity": np.zeros((n, 1)), "live": np.ones(n, bool)}


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GaussianParams.from_numpy(_arrays(), 0, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GaussianParams.empty(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Camera.from_rt(np.eye(3), np.zeros(3), 50.0, 50.0, 32, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_mask(np.zeros((8, 8, 3)), LocalizePipelineConfig(), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gsl.resolve_device()


def test_cpu_on_request(no_cuda):
    g = GaussianParams.from_numpy(_arrays(), 0, 0, device="cpu")
    assert g.device.type == "cpu" and g.xyz.dtype == torch.float32
    cam = Camera.from_rt(np.eye(3), np.zeros(3), 50.0, 50.0, 32, 32,
                         device="cpu")
    assert cam.w2c.device.type == "cpu"
    mask = build_mask(np.zeros((8, 8, 3)), LocalizePipelineConfig(), None,
                      device="cpu")
    assert mask.device.type == "cpu" and mask.shape == (8, 8)
    with pytest.raises(ValueError):
        gsl.resolve_device("meta")


def test_training_entry_points_default_to_cuda(no_cuda):
    from gs_localization_torch.data.scene import SceneInfo
    from gs_localization_torch.mapping.train import MapTrainState
    from gs_localization_torch.pipelines.train_map import train_map

    pts = np.random.default_rng(0).uniform(-1, 1, (8, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GaussianParams.from_pcd(pts, np.zeros((8, 3)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MapTrainState.from_numpy({}, 0, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_map(SceneInfo([], [], pts, np.zeros((8, 3))))
    g = GaussianParams.from_pcd(pts, np.zeros((8, 3)), sh_degree=0,
                                device="cpu")
    assert g.device.type == "cpu" and g.capacity == 8


def test_reset_launches():
    assert gsl.LAUNCHES is _kernels.LAUNCHES
    for name in gsl.LAUNCHES:
        gsl.LAUNCHES[name] += 3
    gsl.reset_launches()
    names = {e.counter or n for n, e in _kernels.TABLE.items()}
    assert gsl.LAUNCHES == dict.fromkeys(names, 0)


def test_scene_entry_points_default_to_cuda(no_cuda, tmp_path):
    """The data layer, LPIPS and the scene runner take the card unless
    asked for the CPU."""
    from gs_localization_torch.data.blender import load_blender_scene
    from gs_localization_torch.data.colmap import (
        ColmapCamera, ColmapImage, write_colmap_model_text)
    from gs_localization_torch.data.scene import (camera_from_colmap,
                                                  load_colmap_scene)
    from gs_localization_torch.ops.lpips import LPIPS
    from gs_localization_torch.ops.undistort import undistort_map
    from gs_localization_torch.pipelines import run_scene

    cam = ColmapCamera(1, "PINHOLE", 8, 6, np.array([5.0, 5.0, 4.0, 3.0]))
    im = ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "a.png",
                     np.zeros((0, 2)), np.zeros((0,), np.int64))
    write_colmap_model_text(str(tmp_path), {1: cam}, {1: im}, {})
    for call in (lambda: camera_from_colmap(cam, im),
                 lambda: load_colmap_scene(str(tmp_path)),
                 lambda: LPIPS([], [], []),
                 lambda: undistort_map(8, 6, 5.0, 5.0, 4.0, 3.0),
                 lambda: load_blender_scene(str(tmp_path)),
                 lambda: run_scene.parse_args(["--scene", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    scene = load_colmap_scene(str(tmp_path), device="cpu")
    assert scene.train_cameras[0].camera.device.type == "cpu"
    args = run_scene.parse_args(["--scene", str(tmp_path), "--device",
                                 "cpu"])
    assert args.device.type == "cpu" and args.stream and args.use_depth


def test_sfm_entry_points_default_to_cuda(no_cuda):
    """The SfM front end takes the card unless asked for the CPU."""
    from gs_localization_torch.pipelines.sfm_init import (
        SfmInitConfig, build_point_model)
    from gs_localization_torch.sfm.bundle_adjust import bundle_adjust_np
    from gs_localization_torch.sfm.features import extract_harris_features
    from gs_localization_torch.sfm.incremental import incremental_mapping
    from gs_localization_torch.sfm.retrieval import top_k_retrieval
    from gs_localization_torch.sfm.sift import extract_sift

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    cam = Camera.from_rt(np.eye(3), np.zeros(3), 50.0, 50.0, 64, 48,
                         device="cpu")
    w2c = np.tile(np.eye(4), (2, 1, 1))
    K = np.tile(np.diag([50.0, 50.0, 1.0]), (2, 1, 1))
    ba = (w2c, K, rng.uniform(-1, 1, (4, 3)) + [0, 0, 4],
          np.array([0, 1, 0, 1]), np.array([0, 1, 2, 3]),
          rng.uniform(0, 40, (4, 2)))
    cfg = SfmInitConfig(num_keypoints=32)
    for call in (
            lambda **kw: build_point_model(
                [np.stack([img] * 3, -1)] * 2, [cam, cam], cfg,
                log_fn=lambda s: None, **kw),
            lambda **kw: bundle_adjust_np(*ba, iters=1, cg_iters=2, **kw),
            lambda **kw: extract_harris_features(img, num_keypoints=32,
                                                 **kw),
            lambda **kw: extract_sift(img, num_keypoints=32, n_octaves=2,
                                      **kw),
            lambda **kw: top_k_retrieval(img[:2], img[:5], k=2, **kw),
            lambda **kw: incremental_mapping([], {}, np.eye(3), **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    build_point_model([np.stack([img] * 3, -1)] * 2, [cam, cam], cfg,
                      log_fn=lambda s: None, device="cpu")
    w, pts, c0, c1 = bundle_adjust_np(*ba, iters=1, cg_iters=2,
                                      device="cpu")
    assert w.shape == (2, 4, 4) and np.isfinite(c1)
    f = extract_harris_features(img, num_keypoints=32, device="cpu")
    assert f.keypoints.device.type == "cpu"
    assert extract_sift(img, num_keypoints=32, n_octaves=2,
                        device="cpu").descriptors.shape == (32, 128)
    assert top_k_retrieval(img[:2], img[:5], k=2, device="cpu")[0].shape \
        == (2, 2)


@pytest.mark.parametrize("module,cls", [
    ("lightglue", "LightGlueNet"), ("loftr", "LoFTRNet"), ("d2net", "D2Net"),
    ("r2d2", "R2D2Net"), ("disk", "DiskNet"), ("dir", "DirNet"),
    ("openibl", "OpenIBLNet"), ("eigenplaces", "EigenPlacesNet")])
def test_networks_default_to_cuda(no_cuda, module, cls):
    """hloc's networks are built on the card unless asked for the CPU."""
    import importlib

    net_cls = getattr(importlib.import_module(
        f"gs_localization_torch.sfm.{module}"), cls)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        net_cls()
    net = net_cls(device="cpu")
    assert not net.training
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    assert not any(p.requires_grad for p in net.parameters())
