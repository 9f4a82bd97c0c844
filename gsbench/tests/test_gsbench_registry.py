"""Every configuration, mix and per-layer metric is found by name, and a new
one is a new file: adding a cell edits no file the benchmark has."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from gsbench import registry, run

ROOT = registry.HERE.parent


def test_every_cell_finds_its_pieces():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert (registry.HERE / "drivers"
                / f"{cell.traffic['driver']}.py").exists()
        assert set(registry.limits(w["name"]))
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(registry.metric(m["name"]).read)
            assert m["moves"] in e2e


def test_config_files_are_the_listed_ones():
    bench = registry.benchmark()
    for c in bench["configs"]:
        assert (ROOT / c["file"]) == registry.HERE / "configs" / \
            f"{c['name']}.json"
        cfg = registry.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] or \
            cfg["source"].startswith(c["source"].split()[0])


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files(tmp_path):
    shutil.copytree(registry.HERE, tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    root = tmp_path / "gsbench"
    before = _digest(root)
    cfg = json.loads((root / "configs" / "7scenes-rgbd.json").read_text())
    cfg["sensor"]["width"], cfg["sensor"]["height"] = 320, 240
    (root / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (root / "traffic" / "new-mix.json").write_text(json.dumps(
        {"driver": "localize", "pool": 8, "pose_trans_m": 0.05,
         "pose_rot_rad": 0.01, "init_tangent": [0.005, 0.01],
         "warmup_calls": 1, "check_queries": 2}))
    (root / "metrics" / "new_metric.loc.py").write_text(
        "def read(ctx, st, window):\n    return 1.0\n")
    (root / "checks" / "new-cell.json").write_text(json.dumps(
        {"limits": {"pose_gap_m": 1e-3, "pose_gap_rad": 1e-3}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-config", "source": "x",
                             "file": "gsbench/configs/new-config.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "new_metric.loc", "unit": "x",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "loc_queries_per_s",
                               "workloads": ["new-cell"]})
    cell = registry.cell(bench, "new-cell", root)
    assert cell.config["sensor"]["width"] == 320
    assert cell.traffic["pool"] == 8
    assert "new_metric.loc" in [m["name"] for m in cell.per_layer]
    assert registry.metric("new_metric.loc", root).read(None, None, None) \
        == 1.0
    assert registry.limits("new-cell", root)["pose_gap_m"] == 1e-3
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        registry.cell(registry.benchmark(), "no-such-cell")


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "gs_localization_tpu_like",
                        types.ModuleType("gs_localization_tpu_like"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "gs_localization_tpu.core",
                        types.ModuleType("gs_localization_tpu.core"))
    assert run.loaded_forbidden() == ["gs_localization_tpu"]
