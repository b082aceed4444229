"""The reference's density control (`reference/densify.py`) against the
program's, and the refining cell (`train_refine.py`) on the CPU:

  - the program's `refine` against the reference's on seeded statistics
    and parameters of a tiny table, at the steps where each rule applies
    (densifying, the screen-size rules, the opacity reset, culling alone
    past `stop_split_at`, an overflowing table): the culled rows, the
    split rows and the duplicated rows whose children are placed, the
    live slots and the restarted Adam rows exactly; the counts exactly;
    the rows kept bit for bit; the children within a tolerance;
  - the statistics one tiny training step accumulates, against the
    reference's from its own step (radii, and the per-tile absgrad of its
    compositor);
  - the configuration's `work` is what the program runs under its
    settings (field calls, compositor channels);
  - a tiny copy of `s1_train_1296` runs end to end with `correct` true;
    the program's refinement with `densify_grad_thresh` doubled turns it
    false; a program that does not count its dropped rows is refused
    before any set-up;
  - `trainer.refine_ms.train` reads the program's `refine.device_ms`.
"""

import copy
import functools
import time

import pytest
import torch

from helpers import FGBENCH, bench, tiny_cell

CELL = "s1_train_1296"
# the children's values: the program rotates the samples with its
# quaternion matrix and an einsum after `safe_norm`, the reference with its
# own matrix and a batched product after a plain norm; f32 rounding of the
# same sums, a few units in the last place of means of size ~1
CHILD_RTOL, CHILD_ATOL = 1e-5, 1e-6
# The tiny copy's limit on the children (`refine_children`), which the
# cell itself does not compare: its refinement at step 24800 splits none
# of its rows (PERF.md §6). On the tiny copy's 51 split rows the program
# reads 4.6e-9, the bf16 control 2.6e-3 and the doubled gradient threshold
# 1.9.
TINY_CHILDREN_LIMIT = 1e-4


@pytest.fixture(autouse=True)
def _tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    torch.set_num_threads(4)


def settings():
    import run

    _, cfg, _ = run.cell_parts(bench(), CELL)
    return dict(cfg["settings"]["pipeline"]["model"])


def table(n_cap, n_live, seed):
    """A seeded (n_cap)-slot table, its first n_live slots live: sizes
    around the size threshold (0.01) and a tenth over the cull size
    (0.06), opacities around the cull threshold, screen sizes around both
    screen thresholds, and statistics whose averages straddle the gradient
    threshold (0.004, at half the frame's larger side)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    size = 0.002 + 0.02 * u(n_cap, 1) * (0.8 + 0.2 * u(n_cap, 3))
    size = torch.where(u(n_cap, 1) < 0.1, torch.full_like(size, 0.08), size)
    params = {
        "means": r(n_cap, 3), "scales": torch.log(size), "quats": r(n_cap, 4), "features_dc": r(n_cap, 3),
        "features_rest": r(n_cap, 15, 3), "opacities": 3.0 * r(n_cap, 1),
    }
    alive = torch.arange(n_cap) < n_live
    vis = torch.randint(1, 20, (n_cap,), generator=g).float()
    stats = {"xys_grad_norm": vis * 0.008 * u(n_cap) / 648, "vis_counts": vis, "max_2dsize": 0.2 * u(n_cap) ** 3}
    eps = (r(n_cap, 3), r(n_cap, 3))
    return params, alive, stats, eps


# (step, table slots, live slots): densifying past the warm-up; the
# screen-size rules (before step 4000) past the warm-up; before it; the
# opacity reset (3100); culling alone (past 30000); a table too full
CASES = {
    "densify": (24800, 256, 160), "screen": (3500, 256, 160), "early": (2800, 256, 160),
    "reset": (6100, 256, 160), "cull_only": (30100, 256, 160), "overflow": (24800, 256, 250),
}


def sources(children, params, rows):
    """The source row of each child: the row whose features_rest it
    copies (seeded normals, unique to a row)."""
    key = params["features_rest"][rows].flatten(1)
    out = []
    for c in children.flatten(1):
        hit = torch.nonzero((key == c).all(-1))[:, 0]
        assert hit.numel() == 1
        out.append(int(rows[hit[0]]))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_refine_matches_the_reference(case):
    from freegaussian_tpu_torch.models import densify as program
    from reference import densify as ref

    step, n_cap, n_live = CASES[case]
    s = settings()
    params, alive, stats, eps = table(n_cap, n_live, seed=len(case))
    last_size, num_train = (968, 1296), 33
    cfg = program.DensifyConfig(**{k: s[k] for k in ref.SETTINGS})
    state = program.DensifyState(**{k: v.clone() for k, v in stats.items()})
    p_out, p_alive, _, info = program.refine(cfg, {k: v.clone() for k, v in params.items()}, alive.clone(), state,
                                             step, last_size, num_train, split_eps=eps)
    want = ref.refine(ref.settings_of(s), params, alive, stats, step, last_size, num_train, eps)

    for k in ("num_split", "num_dup", "num_culled", "num_alive", "num_dropped"):
        assert int(info[k]) == want[k], k
    assert bool(info["reset_opacity_moments"]) == want["reset_opacity_moments"]
    assert torch.equal(p_alive, want["alive"])
    assert torch.equal(info["moment_zero_mask"], want["moment_zero"])
    # the decisions: culled rows are the live rows whose Adam rows restart
    assert torch.equal(alive & info["moment_zero_mask"], want["cull"])
    # the placed children: the same slots; each slot's source row and kind
    placed = want["placed"]
    slots = torch.nonzero(placed)[:, 0]
    rows = torch.nonzero(alive)[:, 0]
    got_src = sources(p_out["features_rest"][slots], params, rows)
    assert got_src == sources(want["params"]["features_rest"][slots], params, rows)

    def split_kind(p):  # a split sample's scales are its source's / 1.6, a duplicate's are equal
        return (~torch.isclose(p["scales"][slots], params["scales"][got_src]).all(-1)).tolist()

    kinds = split_kind(p_out)
    assert kinds == split_kind(want["params"])
    if want["num_dropped"] == 0:
        assert {r for r, k in zip(got_src, kinds) if k} == set(torch.nonzero(want["split_kept"])[:, 0].tolist())
        assert {r for r, k in zip(got_src, kinds) if not k} == set(torch.nonzero(want["dup_kept"])[:, 0].tolist())
    kept = want["alive"] & ~placed
    for k in ref.GROUPS:
        assert torch.equal(p_out[k][kept], want["params"][k][kept]), k
        torch.testing.assert_close(p_out[k][placed], want["params"][k][placed], rtol=CHILD_RTOL, atol=CHILD_ATOL)
    if case in ("densify", "screen", "early"):
        assert want["num_split"] > 0 and want["num_culled"] > 0 and slots.numel() > 0, case
    if case == "densify":
        assert want["num_dup"] > 0
    if case == "overflow":
        assert want["num_dropped"] > 0
    if case == "reset":
        assert want["reset_opacity_moments"]
    if case == "cull_only":
        assert want["num_split"] == want["num_dup"] == 0 and want["num_culled"] > 0


def refine_cell(**over):
    """A tiny copy of the refining cell: checked steps 24797-24799, the
    refinement at 24800 in a one-step warm-up."""
    cell, cfg, traffic = tiny_cell(CELL)
    cfg = copy.deepcopy(cfg)
    cfg["settings"]["pipeline"]["model"].update(over)
    limits = dict(traffic["limits"], refine_children=TINY_CHILDREN_LIMIT)
    return cell, cfg, dict(traffic, start_step=24797, warm_steps=1, limits=limits)


def refine_run(**over):
    import train_refine

    cell, cfg, traffic = refine_cell(**over)
    return train_refine.run(cell, cfg, traffic, 2_200_000_005, 0.05, False, time.perf_counter(), device="cpu")


def test_one_step_statistics_match_the_reference(monkeypatch):
    import train
    from reference import core, densify, stage1

    cell, cfg, traffic = refine_cell()
    dev = torch.device("cpu")
    work = train.scratch_dir()
    inputs, trainer = train.prepare(cfg, traffic, 2_200_000_007, dev, work)
    rec = train.Recorder(trainer)
    try:
        trainer.train(1)
    finally:
        rec.close()
    (_, idx, _), = rec.steps
    n = inputs.n
    d = trainer.state.densify
    got = {"xys_grad_norm": d.xys_grad_norm[:n], "vis_counts": d.vis_counts[:n], "max_2dsize": d.max_2dsize[:n]}

    frame = inputs.frames[int(inputs.i_train[idx])]
    batch = stage1.batch_of(frame, inputs.images8, inputs.depth, inputs.flow)
    bg = torch.rand(3, generator=torch.Generator(device=dev).manual_seed(inputs.bg_seed), device=dev)
    params = {k: v.clone().requires_grad_(True) for k, v in inputs.start.items()}
    sink = []
    monkeypatch.setattr(core, "composite", functools.partial(densify.absgrad_composite, sink=sink))
    rcfg = {"ssim_lambda": 0.2, "flow_loss_weight": 0.0, "flow_3d_loss_weight": 0.0, "flow_px_ref": 0.0,
            "sh_degree": 3}
    stage1.step_loss(params, inputs.deform, frame, batch, bg, rcfg)["loss"].backward()
    with torch.no_grad():
        _, vm, K = stage1.camera(frame, dev)
        means, scales, quats = stage1.deformed(inputs.start, inputs.deform, frame["time"])
        radii = core.project(means, quats, scales, vm, K, frame["width"], frame["height"])[3]
    want = densify.accumulate(densify.fresh_statistics(n, dev), radii, densify.absgrad(sink, n),
                              (frame["height"], frame["width"]))
    assert torch.equal(got["vis_counts"], want["vis_counts"])
    torch.testing.assert_close(got["max_2dsize"], want["max_2dsize"], rtol=0, atol=0)
    # the absgrad: each tile's sum of per-pixel gradients, from the two
    # compositors' backwards (f32 sums in another order) and bf16 fields
    # whose outputs move the means by rounding: the norms agree to 1e-3
    rel = (got["xys_grad_norm"] - want["xys_grad_norm"]).norm() / want["xys_grad_norm"].norm()
    assert float(rel) < 1e-3, float(rel)
    assert int((want["vis_counts"] > 1).sum()) > n // 4


def test_work_is_what_the_program_runs(monkeypatch):
    """One tiny step of the configuration: the deform field forward and
    backward as many times as `work.field_calls` says, the compositor over
    `work.channels`."""
    import train
    from freegaussian_tpu_torch.ops import mlp_cuda, rasterize_cuda

    cell, cfg, traffic = refine_cell()
    calls = {"fwd": 0, "bwd": 0, "channels": set()}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    dev = torch.device("cpu")
    inputs, trainer = train.prepare(cfg, traffic, 2_200_000_009, dev, train.scratch_dir())
    monkeypatch.setattr(mlp_cuda, "deform_field_fwd_plain", counting("fwd", mlp_cuda.deform_field_fwd_plain))
    monkeypatch.setattr(mlp_cuda, "deform_field_bwd_plain", counting("bwd", mlp_cuda.deform_field_bwd_plain))
    tiles = rasterize_cuda.rasterize_tiles

    def channels(means2d, conics, colors, *a, **k):
        calls["channels"].add(colors.shape[-1])
        return tiles(means2d, conics, colors, *a, **k)

    monkeypatch.setattr(rasterize_cuda, "rasterize_tiles", channels)
    trainer.train(1)
    work = cfg["work"]
    assert calls["fwd"] == sum(c for _, bwd, _, _, c in work["field_calls"] if not bwd)
    assert calls["bwd"] == sum(c for _, bwd, _, _, c in work["field_calls"] if bwd)
    assert calls["channels"] == {work["channels"]}


def test_refine_cell_is_found_by_name_and_runs_correct():
    import run

    b = bench()
    cell, cfg, traffic = run.cell_parts(b, CELL)
    assert traffic["kind"] == "train_refine" and (FGBENCH / "train_refine.py").is_file()
    assert cfg["name"] == cell["config"] and (FGBENCH / "metrics" / "trainer.refine_ms.train.py").is_file()
    res = refine_run()
    v = res["verdict"]
    assert v["correct"], v
    assert {"loss_first", "grad_median", "change_median", "refine_rows", "refine_counts"} == set(traffic["limits"])
    assert set(v["numbers"]) == set(traffic["limits"]) | {"refine_children"}
    detail = res["refine"]
    assert detail["step"] == 24800 and detail["program"] == detail["reference"]
    assert detail["program"]["num_split"] > 0 and detail["program"]["num_culled"] > 0


@pytest.mark.parametrize("threshold", ["densify_grad_thresh", "cull_alpha_thresh"])
def test_refinement_fault_is_not_correct(threshold, monkeypatch):
    """A threshold doubled in the program's refinement alone
    (`calibrate_refine.plant_fault`): with more rows culled, or fewer
    split, the check fails on the rows and counts it changes (and, for the
    split threshold, on the children)."""
    import calibrate_refine
    from freegaussian_tpu_torch.engine import train_step

    monkeypatch.setattr(train_step, "refine", train_step.refine)  # restored after the planted fault
    calibrate_refine.plant_fault(threshold)
    v = refine_run()["verdict"]
    assert not v["correct"]
    failed = {k for k in ("refine_rows", "refine_counts", "refine_children") if v["numbers"][k] > v["limits"][k]}
    assert {"refine_rows", "refine_counts"} <= failed, v
    if threshold == "densify_grad_thresh":
        assert "refine_children" in failed, v


def test_program_without_the_dropped_count_is_refused_at_once(monkeypatch):
    import train_refine
    from freegaussian_tpu_torch.models import densify

    refine = densify.refine

    def older(*a, **k):
        out = refine(*a, **k)
        out[3].pop("num_dropped")
        return out

    monkeypatch.setattr(densify, "refine", older)
    cell, cfg, traffic = refine_cell()
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="num_dropped"):
        train_refine.run(cell, cfg, traffic, 1, 0.05, False, t0, device="cpu")
    assert time.perf_counter() - t0 < 5.0


def test_refine_ms_reader():
    import run

    reader = run.module_at(FGBENCH / "metrics" / "trainer.refine_ms.train.py")
    from freegaussian_tpu_torch.utils import profiling

    profiling.recorded(reset=True)
    ctx = {"trace": {"busy_s": 1.0}, "steps": 30}
    assert reader.read(ctx) is None  # nothing recorded
    try:
        profiling.put("refine.device_ms", 6.0, key="24900")
        profiling.put("refine.device_ms", 3.0, key="25000")
        assert reader.read(ctx) == pytest.approx(9.0 / 30)
        assert reader.read({"trace": None, "steps": 30}) is None  # an untraced run
    finally:
        profiling.recorded(reset=True)


@pytest.mark.cuda
def test_full_frame_control_and_faults_are_not_correct(tmp_path, monkeypatch):
    """At the cell's own size on the card: the program within every limit,
    the lower-precision control and the half-image fault each outside one;
    with the program's `cull_alpha_thresh` doubled (the refinement at step
    24800 splits none of the seeded scene's rows, so a doubled gradient
    threshold changes nothing there; PERF.md §6), the refinement check
    outside its rows and counts limits, and the bf16 control outside one."""
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA device; this machine has none")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import calibrate
    import calibrate_refine
    import run
    import train_refine
    from freegaussian_tpu_torch.engine import train_step

    _, cfg, traffic = run.cell_parts(bench(), CELL)
    train_limits, refine_limits = train_refine.split_limits(traffic)
    dev = torch.device("cuda")
    line = calibrate.readings(cfg, dict(traffic, limits=train_limits), 2_300_000_011, dev, True)
    assert all(line["program"][k] <= v for k, v in train_limits.items()), line
    assert any(line["control"][k] > v for k, v in train_limits.items()), line
    assert any(line["half_batch"][k] > v for k, v in train_limits.items()), line
    monkeypatch.setattr(train_step, "refine", train_step.refine)  # restored after the planted fault
    calibrate_refine.plant_fault("cull_alpha_thresh")
    got = calibrate_refine.readings(cfg, traffic, 2_300_000_013, dev)
    assert all(got["fault"][k] > refine_limits[k] for k in ("refine_rows", "refine_counts")), got
    assert any(got["control"][k] > v for k, v in refine_limits.items()), got
