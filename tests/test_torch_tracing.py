"""The port's own tracing (`utils/profiling.py`) in the trainer and the two
training steps, on the CPU over a tiny synthetic scene (the trainer set-up
of tests/test_torch_scan_chunk.py: 6 frames of 32 x 32, 50 random
Gaussians, a downscale phase change at step 3):

  - under `profiling.recording()` the chunk loop records its phase spans
    (`chunk.prepare`, `chunk.step`, `chunk.collect`, `chunk.log`, `tuner`,
    `tuner.rebuild` under `tuner`, `refine`, `eval.all`) with each chunk's
    first step as their chunk, in both stages, and the per-step loop its
    `step.dispatch` spans with `refine` inside;
  - the top-level spans of a chunk tile it: the host time between them is
    under 5% of the chunk;
  - every step, replayed or eager, marks its five phases in order, and the
    phase counters count each step once;
  - with recording off nothing is recorded, and the steps are bit-equal to
    a recorded run's;
  - under a CPU `torch.profiler` run the spans are top-level `fg/...`
    events with the step's operations inside them.

The case marked `cuda` (it skips here) holds a graphed step's five phase
times to the replay's own event-timed length; it imports no JAX, so on the
card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from freegaussian_tpu_torch.engine import checkpoints
from freegaussian_tpu_torch.engine.control_trainer import ControlTrainer
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig
from freegaussian_tpu_torch.engine.trainer import Trainer, TrainerConfig
from freegaussian_tpu_torch.models.densify import DensifyConfig
from freegaussian_tpu_torch.models.splat_model import SplatConfig
from freegaussian_tpu_torch.utils import profiling
from freegaussian_tpu_torch.viewer.png import encode_png

FRAMES, SIZE, LIVE = 6, 32, 50
MODEL = dict(
    warm_up=1, num_downscales=1, resolution_schedule=3, tile_size=16, deform_bf16=False, background_color="random",
    flow_loss_weight=0.01, flow_3d_loss_weight=0.01, deform_head_init_scale=1e-4, deform_impl="headsfused",
)
STAGE2 = dict(MODEL, flow_loss_weight=0.0, flow_3d_loss_weight=0.0)
REFINE = dict(refine_start=2, refine_every=2)
PHASE_MARKS = list(profiling.PHASES) + [profiling.END]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """FRAMES seeded frames in the synthetic layout (PNGs by the port's
    encoder, the articulation masks) and a seeded (LIVE, 2) cluster mask."""
    root = tmp_path_factory.mktemp("trace_scene")
    frames = []
    for i in range(FRAMES):
        img = np.random.default_rng(i).uniform(0, 255, size=(SIZE, SIZE, 3)).astype(np.uint8)
        (root / "images").mkdir(exist_ok=True)
        (root / f"images/frame_{i:04d}.png").write_bytes(encode_png(img))
        (root / "mask").mkdir(exist_ok=True)
        mask = np.zeros((SIZE, SIZE, 3), bool)  # the articulation masks the synthetic parser reads
        mask[:, : SIZE // 2, 0] = True
        mask[:, SIZE // 2 :, 1] = i % 2 == 0
        np.save(root / f"mask/{i:04d}.npy", mask)
        c2w = np.eye(4)
        c2w[2, 3] = 4.0 + 0.1 * i
        frames.append({"file_path": f"./images/frame_{i:04d}", "transform_matrix": c2w.tolist(), "time": i / FRAMES})
    (root / "transforms.json").write_text(json.dumps({"camera_angle_x": 0.7, "frames": frames}))
    np.save(root / f"gaussian_mask_{LIVE}x2.npy", np.random.default_rng(0).uniform(size=(LIVE, 2)) < 0.4)
    return root


@pytest.fixture(autouse=True)
def empty_record():
    profiling.profiler_summary(reset=True)
    yield
    profiling.profiler_summary(reset=True)


def _trainer(dataset, out, chunk, stage=1, device="cpu", **kw):
    cfg = TrainerConfig(
        data=str(dataset), dataparser="synthetic", output_dir=str(out), capacity=128, num_random=LIVE,
        steps_per_save=0, steps_per_eval_image=0, steps_per_eval_all_images=4, eval_all_max_images=1,
        steps_per_log=2, seed=3, scan_chunk=chunk,
        splat=SplatConfig(**{**(MODEL if stage == 1 else STAGE2), **kw.pop("splat", {})}),
        densify=DensifyConfig(**kw.pop("densify", {"refine_start": 10**9})),
        optimizers=OptimizersConfig(max_steps=100), **kw,
    )
    if stage == 1:
        return Trainer(cfg, device=device)
    return ControlTrainer(cfg, gaussian_mask_path=dataset / f"gaussian_mask_{LIVE}x2.npy", device=device)


def _chunk_starts(spans):
    return sorted({s["chunk"] for s in spans if s["name"] == "chunk.step"})


@pytest.mark.parametrize("stage", [1, 2])
def test_chunk_loop_records_its_spans(dataset, tmp_path, stage):
    """6 steps in chunks of up to 3 (breaks at the downscale change at 3 and
    the eval cadence at 4): every phase span, with its chunk and parent."""
    kw = {"densify": REFINE} if stage == 1 else {}
    # the later chunks' peaks (88 pairs) pass 85% of 100: one growth, to 200
    t = _trainer(dataset, tmp_path, 3, stage, splat={"isect_capacity": 100}, **kw)
    with profiling.recording():
        t.train(6)
    spans = profiling.recorded()["spans"]
    names = {s["name"] for s in spans}
    want = {"chunk.prepare", "chunk.step", "chunk.collect", "chunk.log", "tuner", "tuner.rebuild", "eval.all"}
    assert want | ({"refine"} if stage == 1 else set()) <= names
    assert _chunk_starts(spans) == [0, 3, 4]
    steps = [s for s in spans if s["name"] == "chunk.step"]
    assert [s["attrs"]["step"] for s in steps] == list(range(6))
    for s in steps:
        assert s["attrs"]["first"] == (s["attrs"]["step"] == s["chunk"])
        assert s["chunk"] <= s["attrs"]["step"] < s["chunk"] + 3
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        parent = by_id[s["parent"]]["name"] if s["parent"] is not None else None
        assert parent == ("tuner" if s["name"] == "tuner.rebuild" else None), s
    tuners = [s["attrs"] for s in spans if s["name"] == "tuner"]
    assert [a["decision"] for a in tuners].count("grow") == 1 and all(a["capacity"] > 0 for a in tuners)
    assert [s["chunk"] for s in spans if s["name"] == "eval.all"] == [3]


def test_per_step_loop_records_dispatch_and_refine(dataset, tmp_path):
    t = _trainer(dataset, tmp_path, 0, densify=REFINE)
    with profiling.recording():
        t.train(4)
    spans = profiling.recorded()["spans"]
    dispatch = [s for s in spans if s["name"] == "step.dispatch"]
    assert [(s["chunk"], s["attrs"]["step"]) for s in dispatch] == [(i, i) for i in range(4)]
    refine = [s for s in spans if s["name"] == "refine"]
    assert [s["attrs"]["step"] for s in refine] == [2]
    assert refine[0]["parent"] == dispatch[2]["id"]
    assert profiling.recorded()["counters"]["step.phase_steps"] == 4


@pytest.mark.parametrize("stage", [1, 2])
def test_spans_tile_each_chunk(dataset, tmp_path, stage):
    t = _trainer(dataset, tmp_path, 3, stage)
    with profiling.recording():
        t.train(6)
    top = {}
    for s in profiling.recorded()["spans"]:
        if s["parent"] is None:
            top.setdefault(s["chunk"], []).append(s)
    assert sorted(top) == [0, 3, 4]
    for chunk, spans in top.items():
        spans.sort(key=lambda s: s["start_ns"])
        extent = max(s["end_ns"] for s in spans) - spans[0]["start_ns"]
        gaps = sum(max(b["start_ns"] - a["end_ns"], 0) for a, b in zip(spans, spans[1:]))
        assert gaps <= 0.05 * extent, (chunk, gaps, extent, [s["name"] for s in spans])


def test_chunk_refinement_records_its_counts(dataset, tmp_path):
    """A chunk of 3 steps from step 12 refining at step 12 (densifying:
    12 mod 60 is past the frames and the cadence), every slot live (the
    random init's rows repeated), so that the splits overflow and some rows
    are culled: its counters equal what `refine_at` returned, its device
    ms is positive; unrecorded, no refine counter."""
    densify = dict(refine_start=3, refine_every=3, reset_alpha_every=20, densify_grad_thresh=0.0,
                   cull_alpha_thresh=0.1)
    returned = []
    for record in (False, True):
        t = _trainer(dataset, tmp_path / str(record), 3, densify=densify)
        st = t.state
        with torch.no_grad():
            rows = torch.arange(st.alive.shape[0]) % int(st.alive.sum())
            for v in st.params.values():
                v.copy_(v[rows])
            st.alive.fill_(True)
        st.step = 12
        inner = t._refine_at

        def refine_at(step, last_size):
            out = inner(step, last_size)
            if out is not None:
                returned.append((step, {k: int(v) for k, v in out.items()}))
            return out

        t._refine_at = refine_at
        with profiling.recording() if record else contextlib.nullcontext():
            t.train(3)
        counters = profiling.recorded()["counters"]
        if not record:
            assert not [k for k in counters if k.startswith("refine.")]
    assert len(returned) == 2 and returned[0] == returned[1] and returned[1][0] == 12
    got = returned[1][1]
    assert got["num_split"] > 0 and got["num_culled"] > 0 and got["num_dropped"] > 0, got
    assert counters["refine.count"] == 1
    for name in ("split", "dup", "culled", "alive", "dropped"):
        assert counters[f"refine.{name}"] == {"12": got[f"num_{name}"]}, name
    assert counters["refine.device_ms"]["12"] > 0


@pytest.mark.parametrize("stage,chunk", [(1, 3), (2, 3), (1, 0), (2, 0)])
def test_each_step_marks_its_phases_in_order(dataset, tmp_path, monkeypatch, stage, chunk):
    seen = []
    mark = profiling.mark
    monkeypatch.setattr(profiling, "mark", lambda phase, device: (seen.append(phase), mark(phase, device)))
    t = _trainer(dataset, tmp_path, chunk, stage)
    with profiling.recording():
        t.train(4)
    assert seen == PHASE_MARKS * 4
    counters = profiling.recorded()["counters"]
    assert counters["step.phase_steps"] == 4
    assert set(counters["step.phase_ms"]) == set(profiling.PHASES)
    assert all(v > 0 for v in counters["step.phase_ms"].values())


def _flat(state):
    out = {}

    def walk(x, p):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{p}.{k}")
        else:
            out[p] = x

    walk(checkpoints.state_dict(state), "")
    return out


def _rows(trainer):
    timing = ("steps_per_sec", "num_rays_per_sec", "fps")
    rows = [json.loads(line) for line in (trainer.out_dir / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in timing} for r in rows]


def test_recording_off_records_nothing_and_changes_no_step(dataset, tmp_path):
    off = _trainer(dataset, tmp_path / "off", 3, densify=REFINE)
    off.train(6)
    assert profiling.recorded() == {"spans": [], "counters": {}}
    assert not profiling.enabled()
    on = _trainer(dataset, tmp_path / "on", 3, densify=REFINE)
    with profiling.recording():
        on.train(6)
    assert profiling.recorded()["spans"]
    a, b = _flat(off.state), _flat(on.state)
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k], k
    assert _rows(off) == _rows(on)


def test_spans_are_fg_events_under_the_profiler(dataset, tmp_path):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = _trainer(dataset, tmp_path, 2, splat=dict(flow_loss_weight=0.0, flow_3d_loss_weight=0.0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        t.train(1)
    assert not profiling.enabled()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    top = [e.name for e in events if e.cpu_parent is None]
    for name in ("chunk.prepare", "chunk.step", "chunk.collect", "chunk.log", "tuner"):
        assert f"fg/{name}" in top, name
    # the step's operations sit inside the chunk.step spans
    inside = [e for e in events if e.name == "aten::mm"]
    assert inside

    def root(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
        return e.name

    assert {root(e) for e in inside} == {"fg/chunk.step"}
    assert [s["name"] for s in profiling.recorded()["spans"]].count("chunk.step") == 1


def test_profiler_summary_prints_the_phase_counters(dataset, tmp_path):
    t = _trainer(dataset, tmp_path, 3)
    with profiling.recording():
        t.train(3)
    table = profiling.profiler_summary(reset=True)
    assert "chunk.step" in table and "step phase" in table
    for phase in profiling.PHASES:
        assert any(line.startswith(phase) for line in table.splitlines()), phase
    assert profiling.recorded() == {"spans": [], "counters": {}}


@pytest.mark.cuda
def test_cuda_graphed_phases_sum_to_the_replay(dataset, tmp_path):
    """A graphed stage-1 chunk (one downscale phase, so one graph): the
    graph's five phase times are positive and sum within 10% of one replay
    timed by events around it; a recorded chunk adds its replays' phases
    once a step, the graph's kernel nodes and the live-block rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the step's graph has no CPU mode)")
    t = _trainer(dataset, tmp_path, 3, device="cuda", splat={"warm_up": 0, "num_downscales": 0})
    t.train(3)  # step 0 captures the graph, steps 1-2 replay it
    (runner,) = t._runners.values()
    (variant,) = runner.graphs
    graph, marks = runner.graphs[variant][0], runner.graphs[variant][3]
    nodes = t.graph_stats["kernel_nodes"][variant]
    assert [p for p, _ in marks] == PHASE_MARKS and nodes > 0
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        runner.cursor.zero_()
        graph.replay()
        start.record()  # after a replay, so the timed one is queued before the device reaches it
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        phases = profiling.graph_phases(marks)
        total = start.elapsed_time(end)
        assert set(phases) == set(profiling.PHASES) and all(v > 0 for v in phases.values()), phases
        assert abs(sum(phases.values()) - total) <= 0.1 * total, (phases, total)
    with profiling.recording():
        t.train(3)
    counters = profiling.recorded()["counters"]
    assert counters["step.phase_steps"] == 3, counters
    assert list(counters["step.kernel_nodes"].values()) == [nodes], counters
    assert sum(counters["step.replays"].values()) == 3, counters
    assert 0 < counters["field.live_rows"] <= counters["field.block_rows"], counters
