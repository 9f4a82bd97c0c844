"""What the per-layer readers and the localize capture take from a run,
driven on the CPU at a tiny size."""

import time

import pytest

import gsbench_tiny
from gsbench import registry, run


def _ctx(cell, trace):
    return run.Ctx(cell, gsbench_tiny.SEED, 2.0, trace, "cpu",
                   time.time())


def test_warm_up_keeps_the_capacities_the_program_grew_to(one_thread):
    cell = gsbench_tiny.cell("cambridge-localize")
    cell.config["raster"]["max_pairs"] = 1 << 11
    cell.config["raster"]["max_per_tile"] = 64
    ctx = _ctx(cell, False)
    drv = registry.driver(cell.traffic["driver"])
    st = drv.setup(ctx)
    assert st.rcfg.max_pairs > 1 << 11 and st.rcfg.max_per_tile > 64
    calls = st.capture.calls
    assert calls[-1]["raster_cfg"] == st.rcfg
    assert not bool(calls[-1]["overflow"])
    window = drv.run_window(ctx, st)
    # the window runs at the grown capacities: one refinement a query
    assert all(len(c) == 1 for _, _, c in st.done)
    assert window["attempted"] == len(st.done)


def test_capture_takes_each_answers_iterations_loss_and_gradient(one_thread):
    cell = gsbench_tiny.cell("cambridge-localize")
    ctx = _ctx(cell, False)
    drv = registry.driver(cell.traffic["driver"])
    st = drv.setup(ctx)
    drv.run_window(ctx, st)
    for _, _, calls in st.done:
        last = calls[-1]
        assert last["iters"] >= 1
        assert last["grad0"] is not None and last["grad0"].shape == (6,)
        assert float(last["loss0"]) > 0


@pytest.mark.parametrize("name, expect", [
    ("cambridge-localize", {"iters_per_query.loc", "rebin_ms.loc"}),
    ("7scenes-train", {"binning_ms.train"})])
def test_traced_run_reads_its_span_metrics(name, expect, one_thread):
    res = run.run_cell(gsbench_tiny.cell(name), gsbench_tiny.SEED, 2.0,
                       True, "cpu")
    assert expect <= set(res["metrics"])
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_training_work_is_counted_on_the_traced_map(one_thread):
    cell = gsbench_tiny.cell("7scenes-train")
    ctx = _ctx(cell, True)
    drv = registry.driver(cell.traffic["driver"])
    st = drv.setup(ctx)
    drv.run_window(ctx, st)
    assert st.traced_map is not None
    live = int(st.traced_map["live"].sum())
    view = ctx.spans.records
    r = drv.work(st, 0)
    assert st.work_map.xyz.shape[0] == live
    assert 0 < r.gaussians <= live and 0 < r.applied <= r.evaluated
    assert drv.flops(st, 0) > r.blend_fwd_flops() + r.blend_bwd_flops()
    assert view    # the spans fired
