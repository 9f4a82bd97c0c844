"""The readers of the port's own spans and counters
(``gsbench/program_records.py`` and its six metrics) on synthetic records,
and on the records of traced runs of the tiny cells on the CPU; and
``gsbench/spans_trace.py`` on those cells."""

import time
from types import SimpleNamespace

import pytest

import gsbench_tiny
from gs_localization_torch.utils import profiling
from gsbench import registry, run

LOC = ("host_syncs_per_query.loc", "upload_mb_per_query.loc",
       "refine_issue_ms.loc", "refine_wait_ms.loc", "rebin_bin_ms.loc")
TRAIN = ("step_issue_ms.train",)
MS = 1_000_000


def _span(sid, name, unit, start_ms, end_ms, parent=None, counts=None,
          notes=None, stream_ms=None, t0=0):
    return {"id": sid, "name": name, "parent": parent, "unit": unit,
            "host_start_ns": t0 + int(start_ms * MS),
            "host_end_ns": t0 + int(end_ms * MS), "counts": counts or {},
            "notes": notes or {}, "stream_ms": stream_ms}


def _query(base, name, t0, iters=2):
    """One query's spans from ``base`` ms on: upload, one rebin, ``iters``
    iterations of render 3 / backward 4 / step 1 / converge 0.5 ms, the
    audit."""
    sid = base * 100
    out = [_span(sid, "localize/batch", name, base, base + 40,
                 notes={"queries": 1}, t0=t0),
           _span(sid + 1, "localize/upload", name, base, base + 2, sid,
                 {"upload_bytes": 2_000_000}, t0=t0),
           _span(sid + 2, "refine/pose", name, base + 2, base + 38, sid,
                 t0=t0),
           _span(sid + 3, "rebin/bin", name, base + 2, base + 5, sid + 2,
                 {"host_sync/bin_mask": 6}, stream_ms=2.5, t0=t0)]
    t = base + 5
    for i in range(iters):
        k = sid + 10 + 5 * i
        out += [_span(k, "refine/render", name, t, t + 3, sid + 2, t0=t0),
                _span(k + 1, "refine/backward", name, t + 3, t + 7, sid + 2,
                      t0=t0),
                _span(k + 2, "refine/step", name, t + 7, t + 8, sid + 2,
                      {"host_sync/se3_row": 1}, t0=t0),
                _span(k + 3, "refine/converge", name, t + 8, t + 8.5,
                      sid + 2, {"host_sync/converge": 1}, t0=t0)]
        out[2]["counts"]["refine_iters"] = i + 1
        t += 8.5
    out.append(_span(sid + 99, "localize/audit", name, base + 38, base + 40,
                     sid, {"host_sync/loc_overflow": 1,
                           "host_sync/pose_download": 1}, t0=t0))
    return out


def _steps(t0):
    out = []
    for it in (7, 8):                    # step 7's audit only: not traced
        sid = 1000 + 10 * it
        out += [_span(sid, "train/step", it, 10 * it, 10 * it + 9, t0=t0),
                _span(sid + 1, "train/load", it, 10 * it, 10 * it + 1, sid,
                      t0=t0),
                _span(sid + 2, "train/render", it, 10 * it + 1,
                      10 * it + 5, sid, t0=t0)]
    out.append(_span(2000, "train/audit", 6, 69, 70, t0=t0))
    return out


@pytest.fixture
def ctx(monkeypatch):
    t0 = time.perf_counter()
    c = SimpleNamespace(device_trace=SimpleNamespace(t0=t0))
    start = time.time_ns()
    old = _query(0, "old", start - 10_000 * MS)       # a run before
    spans = old + _query(1, "q1", start) + _query(50, "q2", start, 3) \
        + _steps(start)
    monkeypatch.setattr(profiling, "records",
                        lambda: {"spans": spans, "counters": {}})
    return c


def _read(name, c):
    return registry.metric(name).read(c, None, None)


def test_readers_on_synthetic_records(ctx):
    # q1: 6 + 2 + 2 + 2 = 12 syncs; q2: 6 + 3 + 3 + 2 = 14
    assert _read("host_syncs_per_query.loc", ctx) == 13.0
    assert _read("upload_mb_per_query.loc", ctx) == pytest.approx(2.0)
    # 5 iterations of 3 + 4 + 1 ms issuing, 0.5 ms waiting
    assert _read("refine_issue_ms.loc", ctx) == pytest.approx(8.0)
    assert _read("refine_wait_ms.loc", ctx) == pytest.approx(0.5)
    assert _read("rebin_bin_ms.loc", ctx) == pytest.approx(2.5)
    # two traced steps of 9 ms, 1 ms of it the load
    assert _read("step_issue_ms.train", ctx) == pytest.approx(8.0)


@pytest.mark.parametrize("name", LOC + TRAIN)
def test_readers_give_none_when_nothing_was_recorded(name, monkeypatch):
    c = SimpleNamespace(device_trace=SimpleNamespace(t0=time.perf_counter()))
    monkeypatch.setattr(profiling, "records",
                        lambda: {"spans": [], "counters": {}})
    assert _read(name, c) is None
    # a program without the recorder (an older commit)
    monkeypatch.delattr(profiling, "records")
    assert _read(name, c) is None
    # no device trace in the run
    assert _read(name, SimpleNamespace(device_trace=SimpleNamespace())) \
        is None


@pytest.mark.parametrize("cell, names", [("cambridge-localize", LOC),
                                         ("7scenes-train", TRAIN)])
def test_traced_run_reads_the_programs_records(cell, names, one_thread):
    res = run.run_cell(gsbench_tiny.cell(cell), gsbench_tiny.SEED, 2.0,
                       True, "cpu")
    got = res["metrics"]
    assert set(names) <= set(got)
    assert all(got[n]["value"] > 0 for n in names)
    if cell == "cambridge-localize":
        # on the CPU only the reads count: convergence, overflow, pose
        assert got["host_syncs_per_query.loc"]["value"] == 3.0


@pytest.mark.parametrize("cell, units, spans", [
    ("cambridge-localize", 2, "localize/batch"),
    ("7scenes-train", 3, "train/step")])
def test_spans_trace_writes_the_split(cell, units, spans, tmp_path,
                                      one_thread):
    import json

    from gsbench import spans_trace

    res = spans_trace.trace_units(gsbench_tiny.cell(cell), gsbench_tiny.SEED,
                                  units, str(tmp_path), "cpu", first=6)
    assert res["units"] == units and res["seconds"] > 0
    out = json.loads((tmp_path / "spans.json").read_text())
    assert out["by_name"][spans]["count"] == units
    assert (tmp_path / "trace.json").exists()
    assert json.loads((tmp_path / "digest.json").read_text())["units"] == \
        units
