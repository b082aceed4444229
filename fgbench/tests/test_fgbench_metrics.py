"""Each per-layer reader returns None when the run has nothing for it, and
reads a synthetic trace as its file says."""

import json

import pytest

from helpers import FGBENCH, bench


def reader(name):
    import run

    return run.module_at(FGBENCH / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", [m["name"] for m in bench()["per_layer"]])
def test_nothing_to_read_gives_none(name):
    cfg = json.loads((FGBENCH / "configs" / "fg-sim-stage1.json").read_text())
    assert reader(name).read({"config": cfg, "steps": 0}) is None


def test_training_readers_on_a_synthetic_trace():
    cfg = json.loads((FGBENCH / "configs" / "fg-sim-stage1.json").read_text())
    trace = {
        "busy_s": 0.9, "window_s": 1.0, "device_events": 100,
        "kernel_s": {"void field_fwd_kernel<true>(...)": 0.02, "field_dgrad_kernel<true>": 0.02,
                     "rasterize_fwd_kernel<32>": 0.01, "rasterize_bwd_walk<32, false>": 0.02, "other": 0.5},
    }
    ctx = {"config": cfg, "steps": 10, "trace": trace,
           "counts": {"live": 100000, "walked_pairs": 3e7, "isects": 160000, "width": 640, "height": 480, "tile": 32}}
    assert reader("device_idle_share.train").read(ctx) == pytest.approx(10.0)
    field = reader("field_roofline.train").read(ctx)
    comp = reader("compositor_roofline.train").read(ctx)
    mfu = reader("mfu.train").read(ctx)
    assert 0 < field < 100 and 0 < comp < 100 and 0 < mfu < 100
    ctx["trace"] = dict(trace, kernel_s={"other": 0.5})
    assert reader("field_roofline.train").read(ctx) is None
    assert reader("compositor_roofline.train").read(ctx) is None


def test_viewer_readers():
    ctx = {"render_ms": 14.0, "request_ms": 36.0}
    assert reader("view.render_ms").read(ctx) == 14.0
    assert reader("view.host_ms").read(ctx) == pytest.approx(22.0)
