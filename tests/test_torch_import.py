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
from gs_localization_torch.core.camera import Camera
from gs_localization_torch.core.gaussians import GaussianParams
from gs_localization_torch.pipelines.localize import (
    LocalizePipelineConfig, build_mask)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gs_localization_tpu")
# the card tests and their helper run where JAX is not installed
PORT_FILES = sorted((ROOT / "gs_localization_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "blend_ablation.py",
    ROOT / "tests" / "test_torch_cuda.py", ROOT / "tests" / "blend_edges.py"]


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
            "render_eval.py"} <= names


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
    gsl.LAUNCHES["stream_fwd"] += 3
    gsl.LAUNCHES["pregathered_bwd"] += 1
    gsl.reset_launches()
    assert gsl.LAUNCHES == {"stream_fwd": 0, "stream_bwd": 0,
                            "pregathered_fwd": 0, "pregathered_bwd": 0}


def test_scene_entry_points_default_to_cuda(no_cuda, tmp_path):
    """The data layer, LPIPS and the scene runner take the card unless
    asked for the CPU."""
    from gs_localization_torch.data.colmap import (
        ColmapCamera, ColmapImage, write_colmap_model_text)
    from gs_localization_torch.data.scene import (camera_from_colmap,
                                                  load_colmap_scene)
    from gs_localization_torch.ops.lpips import LPIPS
    from gs_localization_torch.pipelines import run_scene

    cam = ColmapCamera(1, "PINHOLE", 8, 6, np.array([5.0, 5.0, 4.0, 3.0]))
    im = ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "a.png",
                     np.zeros((0, 2)), np.zeros((0,), np.int64))
    write_colmap_model_text(str(tmp_path), {1: cam}, {1: im}, {})
    for call in (lambda: camera_from_colmap(cam, im),
                 lambda: load_colmap_scene(str(tmp_path)),
                 lambda: LPIPS([], [], []),
                 lambda: run_scene.parse_args(["--scene", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    scene = load_colmap_scene(str(tmp_path), device="cpu")
    assert scene.train_cameras[0].camera.device.type == "cpu"
    args = run_scene.parse_args(["--scene", str(tmp_path), "--device",
                                 "cpu"])
    assert args.device.type == "cpu" and args.stream and args.use_depth
