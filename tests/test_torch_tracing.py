"""The port's spans and counters (``utils/profiling.py``): off without a
profiler, nested with their parents and units under one, on the profiler's
clock; what a localization and a training run record; ``trace()``'s two
files; the idle time filed under each span."""

import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gs_localization_torch.data.scene import CameraInfo, SceneInfo
from gs_localization_torch.loc import TrackingConfig
from gs_localization_torch.pipelines import train_map as tm
from gs_localization_torch.pipelines.localize import (
    LocalizePipelineConfig, QuerySpec, localize_queries)
from gs_localization_torch.raster import RasterizerConfig, rasterize
from gs_localization_torch.utils import profiling
from helpers import make_camera, random_scene
from torch_bridge import camera_to_torch, gaussians_to_torch

CFG = RasterizerConfig(max_pairs=1 << 14, max_per_tile=256,
                       max_render=1 << 14, pallas_chunk=128)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_name(rec):
    out = {}
    for s in rec["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing():
    profiling.reset()
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("x", unit=1), profiling.span("y")
    assert a is b                          # the one shared null context
    with a:
        profiling.count("upload_bytes", 5)
        profiling.note(k=1)
        assert profiling.host_read("site", torch.tensor(2.5)) == 2.5
    assert profiling.records() == {"spans": [], "counters": {}}


def test_waits_count_on_the_card_only():
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_wait("mask", torch.device("cpu"), 2)
        profiling.count_wait("mask", torch.device("cuda"), 2)
        t = profiling.upload(np.ones((2, 3), np.float64), "cpu")
    assert t.dtype == torch.float32 and t.shape == (2, 3)
    assert profiling.records()["counters"] == {"host_sync/mask": 2,
                                               "upload_bytes": 24}


def test_spans_nest_with_parents_and_units():
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a", unit="q1"):
            profiling.count("n", 2)
            with profiling.span("b"):
                profiling.note(cap=8)
                with profiling.span("c", unit="other"):
                    profiling.count("n")
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            profiling.count("m")
    rec = profiling.records()
    s = {r["name"]: r for r in rec["spans"]}
    assert [r["name"] for r in rec["spans"]] == list("abcde")
    assert s["a"]["parent"] is None and s["e"]["parent"] is None
    assert s["b"]["parent"] == s["d"]["parent"] == s["a"]["id"]
    assert s["c"]["parent"] == s["b"]["id"]
    assert [s[k]["unit"] for k in "abcde"] == ["q1", "q1", "other", "q1",
                                               None]
    assert s["a"]["counts"] == {"n": 2} and s["c"]["counts"] == {"n": 1}
    assert s["b"]["notes"] == {"cap": 8}
    assert rec["counters"] == {"n": 3, "m": 1}
    for r in rec["spans"]:
        assert r["host_start_ns"] <= r["host_end_ns"]
        assert r["stream_ms"] is None            # no card
    own = profiling.self_host_ms(rec["spans"])
    dur = {r["name"]: (r["host_end_ns"] - r["host_start_ns"]) / 1e6
           for r in rec["spans"]}
    assert own[s["a"]["id"]] == pytest.approx(dur["a"] - dur["b"] - dur["d"])


def test_records_start_on_the_profilers_clock():
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with profiling.span(f"clock{i}"):
                torch.ones(16).sum()
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gsloc/")]
    # plain CPU ranges: a user annotation would also be laid over the
    # device timeline as a device event
    assert not any(e.is_user_annotation() for e in ranges)
    starts = {e.name(): e.start_ns() for e in ranges}
    rec = profiling.records()
    assert len(rec["spans"]) == 5
    for r in rec["spans"]:
        assert abs(starts["gsloc/" + r["name"]] - r["host_start_ns"]) < 1e6


@pytest.fixture(scope="module")
def query():
    g = gaussians_to_torch(random_scene(np.random.default_rng(0), 300))
    cam = camera_to_torch(make_camera(64, 48, fov=1.0))
    with torch.no_grad():
        img = rasterize(g, cam, CFG).color.numpy()
    tau = torch.tensor([0.01, -0.008, 0.012, 0.02, -0.015, 0.01])
    init = cam.with_delta(tau)
    return g, QuerySpec(name="q0", camera=init, image=img)


def _localize_once(g, q):
    # one iteration: the first update lies far below a convergence of 1
    cfg = LocalizePipelineConfig(tracking=TrackingConfig(
        num_iters=5, lr=1e-3, convergence=1.0, monocular=True,
        pose_mode=True, rebin_every=10))
    return localize_queries(g, [q], cfg, CFG, log_fn=lambda s: None)


def test_localize_records_its_phases_and_counts(query):
    g, q = query
    _localize_once(g, q)                       # warm the CPU kernels
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        res, _ = _localize_once(g, q)
    assert res["q0"].shape == (4, 4)
    rec = profiling.records()
    c = rec["counters"]
    syncs = {k: v for k, v in c.items() if k.startswith("host_sync/")}
    assert syncs == {"host_sync/converge": 1, "host_sync/loc_overflow": 1,
                     "host_sync/pose_download": 1}
    assert c["upload_bytes"] == 2 * q.image.astype(np.float32).nbytes
    assert c["refine_iters"] == 1 and c["rebins"] == 1
    assert "capacity_growths" not in c
    names = _by_name(rec)
    (batch,) = names["localize/batch"]
    assert batch["unit"] == "q0" and batch["notes"] == {"queries": 1}
    assert all(s["unit"] == "q0" for s in rec["spans"])
    (refine,) = names["localize/refine"]
    assert refine["notes"]["max_pairs"] == CFG.max_pairs
    for name in ("localize/upload", "localize/audit", "refine/pose",
                 "refine/rebin", "rebin/preprocess", "rebin/bin",
                 "rebin/gather", "refine/render", "refine/backward",
                 "refine/step", "refine/converge"):
        assert len(names[name]) == 1, name
    ids = {s["id"]: s for s in rec["spans"]}
    assert ids[names["rebin/bin"][0]["parent"]]["name"] == "refine/rebin"
    assert ids[names["refine/pose"][0]["parent"]]["name"] == \
        "localize/refine"
    # the leaves account for the batch's host time
    parents = {s["parent"] for s in rec["spans"]}
    leaves = sum(s["host_end_ns"] - s["host_start_ns"]
                 for s in rec["spans"] if s["id"] not in parents)
    assert leaves >= 0.9 * (batch["host_end_ns"] - batch["host_start_ns"])


def test_trace_writes_the_localize_spans(query, tmp_path):
    g, q = query
    with profiling.trace(str(tmp_path)):
        _localize_once(g, q)
    assert (tmp_path / "trace.json").exists()
    out = json.loads((tmp_path / "spans.json").read_text())
    assert out["by_name"]["localize/batch"]["count"] == 1
    assert out["by_name"]["refine/converge"]["host_ms"] > 0
    assert out["counters"]["refine_iters"] == 1
    assert len(out["spans"]) == sum(d["count"]
                                    for d in out["by_name"].values())
    assert out["device"]["activities"] == 0     # no card
    assert out["by_name"]["localize/batch"]["device_idle_ms"] is None


def test_idle_time_is_filed_under_the_innermost_span():
    ms = 1_000_000
    spans = [dict(id=0, name="outer", parent=None, unit=None,
                  host_start_ns=0, host_end_ns=100 * ms, stream_ms=None),
             dict(id=1, name="inner", parent=0, unit=None,
                  host_start_ns=20 * ms, host_end_ns=60 * ms,
                  stream_ms=None)]
    busy = [[10 * ms, 30 * ms], [40 * ms, 50 * ms], [55 * ms, 120 * ms]]
    # the profile's clock runs 1 ms ahead of the host stamps
    ranges = {s["id"]: (s["host_start_ns"] + ms, s["host_end_ns"] + ms)
              for s in spans}
    out = profiling.summarize({"spans": spans, "counters": {}}, busy,
                              ranges, (0, 130 * ms))
    outer, inner = out["by_name"]["outer"], out["by_name"]["inner"]
    # inner [21, 61): busy 9 + 10 + 6 -> idle 15; outer [1, 101): busy
    # 20 + 10 + 46 -> idle 24, of which 9 outside inner
    assert inner["device_idle_ms"] == pytest.approx(15.0)
    assert outer["device_idle_ms"] == pytest.approx(24.0)
    assert outer["self_device_idle_ms"] == pytest.approx(9.0)
    assert outer["self_host_ms"] == pytest.approx(60.0)
    assert out["device"] == {"activities": 3, "busy_ms": 95.0,
                             "window_ms": 130.0, "idle_ms": 35.0}


def test_train_map_records_each_step_and_the_densify_counts(monkeypatch):
    target = gaussians_to_torch(random_scene(np.random.default_rng(11), n=80,
                                             sh_degree=1))
    cam = camera_to_torch(make_camera(48, 32))
    rcfg = RasterizerConfig(max_pairs=1 << 12, max_per_tile=256,
                            pallas_chunk=32)
    with torch.no_grad():
        img = rasterize(target, cam, rcfg).color.numpy()
    rng = np.random.default_rng(12)
    pts = (target.xyz.numpy()[:50]
           + 0.05 * rng.standard_normal((50, 3))).astype(np.float32)
    scene = SceneInfo([CameraInfo(uid=0, name="c0", camera=cam)], [], pts,
                      rng.uniform(0.2, 0.8, (50, 3)).astype(np.float32),
                      extent=5.0)
    reports, inner = [], tm.densify_and_prune

    def densify(*args, **kwargs):
        out = inner(*args, **kwargs)
        reports.append(out[3])
        return out

    monkeypatch.setattr(tm, "densify_and_prune", densify)
    cfg = tm.TrainPipelineConfig(
        iterations=12, sh_degree=1, capacity_multiplier=2.0,
        densify_from=5, densify_until=30, densification_interval=10,
        opacity_reset_interval=10_000, test_iterations=(),
        save_iterations=(), log_every=100, percent_dense=0.01,
        densify_grad_threshold=0.0)
    logs = []
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tm.train_map(scene, cfg=cfg, raster_cfg=rcfg,
                     image_loader=lambda info: (img, None),
                     log_fn=logs.append, device="cpu")
    rec = profiling.records()
    names = _by_name(rec)
    assert [s["unit"] for s in names["train/step"]] == list(range(1, 13))
    assert all(s["parent"] is None for s in names["train/step"])
    for child in ("train/load", "train/render", "train/loss",
                  "train/backward", "train/adam"):
        assert len(names[child]) == 12, child
    assert len(names["render/binning"]) == 12
    assert [s["unit"] for s in names["train/audit"]] == [10]
    assert [s["unit"] for s in names["train/densify"]] == [10]
    (report,) = reports
    c = rec["counters"]
    got = [c.get(k, 0) for k in ("densify_cloned", "densify_split",
                                 "densify_pruned", "densify_dropped")]
    assert got == [int(report.num_cloned), int(report.num_split),
                   int(report.num_pruned), int(report.dropped)]
    assert got[0] + got[1] > 0                 # the round densified
    (line,) = [s for s in logs if "densify:" in s]
    assert re.search(rf"cloned {got[0]} split {got[1]} pruned {got[2]}",
                     line)
    assert c["host_sync/train_audit"] == 2
    assert c["upload_bytes"] == img.astype(np.float32).nbytes
