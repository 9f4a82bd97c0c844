"""The command's refusals: no card, no fallback to the CPU; no JAX and no
JAX package in what the benchmark imports; a checkout without the program
cannot run."""

import os
import shutil
import subprocess
import sys

import pytest

from gsbench import registry

ROOT = str(registry.HERE.parent)


def _run(args, cwd=ROOT, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", BENCH_RUN="x")
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "gsbench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    p = _run(["--workload", "cambridge-localize", "--seed", str(2**33),
              "--seconds", "1", "--trace", "0"])
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_imports_no_jax():
    code = ("import sys, gsbench.run as r, gsbench.calibrate, gsbench.trace; "
            "from gsbench import registry; "
            "[registry.driver(d) for d in ('localize', 'train')]; "
            "[registry.metric(p.stem) for p in "
            "(registry.HERE / 'metrics').glob('*.py')]; "
            "import gs_localization_torch.pipelines.localize, "
            "gs_localization_torch.pipelines.train_map; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gs_localization_tpu'}))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_it_fails(tmp_path):
    shutil.copytree(registry.HERE, tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _run(["--workload", "cambridge-localize", "--seed", "1",
              "--seconds", "1", "--trace", "0"], cwd=str(tmp_path),
             env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_source_file_names_the_jax_package():
    for path in registry.HERE.rglob("*.py"):
        text = path.read_text()
        for bad in ("import jax", "from jax", "gs_localization_tpu"):
            if path.name == "run.py" and bad == "gs_localization_tpu":
                continue            # the forbidden-module list names it
            if path.name == "test_gsbench_harness.py":
                continue
            if path.name in ("test_gsbench_registry.py",) \
                    and bad == "gs_localization_tpu":
                continue
            assert bad not in text, (path, bad)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from gsbench import run

    cell = registry.cell(registry.benchmark(), "cambridge-localize")
    res = run.run_cell(cell, 2**33 + 1, 2.0, False, "cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
