"""The port's ``utils``: config inheritance (against the JAX package's),
the JSONL metrics logger, a profiler trace with the port's spans, and
the web viewer serving frames on a free port."""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from gs_localization_tpu.utils import config as jconfig
from gs_localization_torch.raster import RasterizerConfig
from gs_localization_torch.utils import load_config, merge_config
from gs_localization_torch.utils.logging import (MetricsLogger,
                                                 timestamped_print)
from gs_localization_torch.utils import profiling
from gs_localization_torch.utils.profiling import trace
from gs_localization_torch.utils.viewer import orbit_w2c, serve
from helpers import random_scene
from torch_bridge import gaussians_to_torch


def test_config_inherit_chain_matches_jax(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "Training:\n  lr: 0.1\n  iters: 10\n  sched: {a: 1, b: 2}\n"
        "Dataset:\n  type: base\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "mid.yaml").write_text(
        "inherit_from: ../base.yaml\nTraining:\n  sched: {b: 3}\n")
    (tmp_path / "sub" / "child.yaml").write_text(
        "inherit_from: mid.yaml\nTraining:\n  lr: 0.2\nExtra: [1, 2]\n")
    cfg = load_config(str(tmp_path / "sub" / "child.yaml"))
    assert cfg == jconfig.load_config(str(tmp_path / "sub" / "child.yaml"))
    assert cfg == {"Training": {"lr": 0.2, "iters": 10,
                                "sched": {"a": 1, "b": 3}},
                   "Dataset": {"type": "base"}, "Extra": [1, 2]}
    parent = {"a": {"x": 1, "y": {"z": 2}}, "b": 1}
    child = {"a": {"y": {"w": 3}}, "b": {"new": 1}}
    assert merge_config(child, parent) == jconfig.merge_config(child, parent)
    assert parent == {"a": {"x": 1, "y": {"z": 2}}, "b": 1}  # not mutated


def test_metrics_logger(tmp_path, capsys):
    log = MetricsLogger(str(tmp_path / "logs"), also_stdout=True)
    log.scalar("loss", 0.5, 3)
    log.scalars({"psnr": torch.tensor(21.5), "skip": "text",
                 "vec": torch.ones(2)}, 4)
    log.close()
    log.close()
    recs = [json.loads(line) for line in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["tag"], r["value"]) for r in recs] == [
        (3, "loss", 0.5), (4, "psnr", 21.5)]
    timestamped_print("hello")
    out = capsys.readouterr().out
    assert "[3] loss = 0.5" in out and "[4] psnr = 21.5" in out
    assert out.splitlines()[-1].startswith("hello [")


def test_step_timer_on_cpu(tmp_path):
    """``trace()`` writes the Chrome trace and the spans it recorded, from
    a reset: a span opened before it is gone, one inside it is kept."""
    with torch.profiler.profile():
        with profiling.span("before"):
            profiling.count("before")
    with trace(str(tmp_path / "prof")) as prof:
        with profiling.span("outer", unit="u0"):
            profiling.count("upload_bytes", 12)
            with profiling.span("inner"):
                time.sleep(0.002)
                torch.ones(64).sum()
    assert prof is not None and (tmp_path / "prof" / "trace.json").exists()
    names = [e["name"] for e in json.loads(
        (tmp_path / "prof" / "trace.json").read_text())["traceEvents"]]
    assert "gsloc/outer" in names and "gsloc/inner" in names
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert [s["name"] for s in spans["spans"]] == ["outer", "inner"]
    assert spans["counters"] == {"upload_bytes": 12}
    outer, inner = spans["by_name"]["outer"], spans["by_name"]["inner"]
    assert outer["count"] == inner["count"] == 1
    assert inner["host_ms"] >= 2.0
    assert outer["self_host_ms"] == pytest.approx(
        outer["host_ms"] - inner["host_ms"])
    # no card: no stream time and no device intervals to find idle time in
    assert inner["stream_ms"] is None and inner["device_idle_ms"] is None
    assert spans["device"]["activities"] == 0
    assert spans["device"]["idle_ms"] is None


def test_viewer_serves_frames():
    g = gaussians_to_torch(random_scene(np.random.default_rng(0), n=80,
                                        sh_degree=1))
    cfg = RasterizerConfig(max_pairs=1 << 13, max_per_tile=64,
                           pallas_chunk=32)
    httpd = serve(g, width=64, height=48, port=0, raster_cfg=cfg,
                  block=False)
    host, port = httpd.server_address[:2]
    assert host == "127.0.0.1"  # loopback unless the caller asks otherwise
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                      timeout=30).read()
        assert b"gsloc viewer" in page and b"width=64" in page
        frame = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/render?az=0.3&el=0.1&r=4",
            timeout=120).read()
        assert frame[:2] == b"\xff\xd8" and len(frame) > 500  # a JPEG
    finally:
        httpd.shutdown()
        httpd.server_close()
    # the orbit camera looks at its centre from distance r
    w2c = orbit_w2c(0.3, 0.1, 4.0, 0.0, 0.0, 3.5)
    R, t = w2c[:3, :3].astype(np.float64), w2c[:3, 3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(R @ np.array([0.0, 0.0, 3.5]) + t,
                               [0.0, 0.0, 4.0], atol=1e-5)
