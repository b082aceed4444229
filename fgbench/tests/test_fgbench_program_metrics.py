"""The readers of the program's own record (`metrics/program.py` and the
eight metrics over it): each gives its number from a planted record, and
None from an empty one, an untraced run or a program without the record;
`BENCHMARK.json` holds their entries as the contract asks."""

import pytest

from helpers import FGBENCH, bench

EIGHT = {
    "step.forward_ms.train": ("ms", "program_span", "train step"),
    "step.loss_ms.train": ("ms", "program_span", "train step"),
    "step.backward_ms.train": ("ms", "program_span", "train step"),
    "step.optimizer_ms.train": ("ms", "program_span", "train step"),
    "step.bookkeeping_ms.train": ("ms", "program_span", "train step"),
    "trainer.boundary_ms.train": ("ms", "program_span", "train verbs, trainer"),
    "step.kernels.train": ("count", "program_counter", "train step"),
    "field.live_block_fill.train": ("%", "program_counter", "field kernels"),
}


def reader(name):
    import run

    return run.module_at(FGBENCH / "metrics" / f"{name}.py")


def span(i, name, chunk, start_ms, end_ms, parent=None, **attrs):
    return {"name": name, "id": i, "parent": parent, "chunk": chunk, "start_ns": int(start_ms * 1e6),
            "end_ns": int(end_ms * 1e6), "attrs": attrs}


def planted():
    """Two chunks of 2 steps: chunk 10 collects at 9 ms, chunk 12's first
    replay starts at 10.5 ms (a 1.5 ms boundary after chunk 10's 2 steps);
    4 replays of 0.25 ms."""
    spans = [
        span(0, "chunk.prepare", 10, 0.0, 1.0), span(1, "chunk.step", 10, 1.0, 1.25),
        span(2, "chunk.step", 10, 1.3, 1.55), span(3, "chunk.collect", 10, 1.6, 9.0, steps=2),
        span(4, "chunk.log", 10, 9.0, 9.2), span(5, "tuner", 10, 9.2, 9.3),
        span(6, "tuner.rebuild", 10, 9.22, 9.28, parent=5),
        span(7, "chunk.prepare", 12, 9.3, 10.5), span(8, "chunk.step", 12, 10.5, 10.75),
        span(9, "chunk.step", 12, 10.8, 11.05), span(10, "chunk.collect", 12, 11.1, 19.0, steps=2),
    ]
    counters = {
        "step.phase_ms": {"forward": 12.0, "loss": 2.0, "backward": 20.0, "optimizer": 30.0, "bookkeeping": 8.0},
        "step.phase_steps": 4.0,
        "step.replays": {"(640, 480, 3, 600000, True, False)": 3, "(640, 480, 3, 600000, True, True)": 1},
        "step.kernel_nodes": {"(640, 480, 3, 600000, True, False)": 3400, "(640, 480, 3, 600000, True, True)": 3500},
        "field.live_rows": 150000, "field.block_rows": 200000,
    }
    return {"spans": spans, "counters": counters}


WANT = {
    "step.forward_ms.train": 3.0, "step.loss_ms.train": 0.5, "step.backward_ms.train": 5.0,
    "step.optimizer_ms.train": 7.5, "step.bookkeeping_ms.train": 2.0,
    "trainer.boundary_ms.train": 1.5 / 2,
    "step.kernels.train": 3400, "field.live_block_fill.train": 75.0,
}


@pytest.fixture
def profiling():
    from freegaussian_tpu_torch.utils import profiling

    profiling.recorded(reset=True)
    yield profiling
    profiling.recorded(reset=True)


@pytest.mark.parametrize("name", sorted(EIGHT))
def test_reader_on_a_planted_record(name, profiling, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda reset=False: planted())
    ctx = {"trace": {"busy_s": 1.0}, "steps": 4}
    assert reader(name).read(ctx) == pytest.approx(WANT[name])


def test_boundary_counts_the_steps_before_each_boundary(profiling, monkeypatch):
    """Three chunks of 10 steps hold two boundaries (1.5 ms and 3.5 ms): the
    metric is their sum over the 20 steps of the chunks they follow, not
    over the window's 30."""
    spans = []
    for c, (t0, t1) in enumerate([(0.0, 20.0), (21.0, 40.0), (43.0, 60.0)]):
        chunk = 10 * c
        spans += [
            span(4 * c, "chunk.prepare", chunk, t0, t0 + 0.5),
            span(4 * c + 1, "chunk.step", chunk, t0 + 0.5, t0 + 1.0),
            span(4 * c + 2, "chunk.collect", chunk, t0 + 1.0, t1, steps=10),
            span(4 * c + 3, "chunk.log", chunk, t1, t1 + 0.2),
        ]
    monkeypatch.setattr(profiling, "recorded", lambda reset=False: {"spans": spans, "counters": {}})
    ctx = {"trace": {"busy_s": 1.0}, "steps": 30}
    assert reader("trainer.boundary_ms.train").read(ctx) == pytest.approx((1.5 + 3.5) / 20)


@pytest.mark.parametrize("name", sorted(EIGHT))
def test_reader_on_an_empty_record_gives_none(name, profiling, monkeypatch):
    ctx = {"trace": {"busy_s": 1.0}, "steps": 4}
    assert reader(name).read(ctx) is None  # nothing recorded in this process
    monkeypatch.setattr(profiling, "recorded", lambda reset=False: planted())
    assert reader(name).read({"steps": 4}) is None  # an untraced run
    monkeypatch.delattr(profiling, "recorded")
    assert reader(name).read(ctx) is None  # a program that keeps no record


def test_readers_on_the_program_s_own_record(profiling):
    """The names the trainer records under reach the readers: spans and
    counters made through the program's API."""
    import torch

    with profiling.recording():
        for chunk in (0, 2):
            profiling.set_chunk(chunk)
            with profiling.profile_section("chunk.prepare"):
                pass
            for step in (chunk, chunk + 1):
                with profiling.profile_section("chunk.step", step=step):
                    for phase in profiling.PHASES + (profiling.END,):
                        profiling.mark(phase, torch.device("cpu"))
            with profiling.profile_section("chunk.collect", steps=2):
                profiling.add("step.replays", 2, key="g")
                profiling.put("step.kernel_nodes", 17, key="g")
                profiling.add("field.live_rows", 96)
                profiling.add("field.block_rows", 128)
        profiling.set_chunk(None)
    ctx = {"trace": {"busy_s": 1.0}, "steps": 4}
    values = {name: reader(name).read(ctx) for name in EIGHT}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["step.kernels.train"] == 17 and values["field.live_block_fill.train"] == 75.0


def test_benchmark_holds_the_eight_entries():
    b = bench()
    cells = ["s1_train_chunk10", "s2_train_chunk10"]
    got = {m["name"]: m for m in b["per_layer"]}
    for name, (unit, source, layer) in EIGHT.items():
        m = got[name]
        assert (m["unit"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
            unit, source, layer, "train_step_ms", cells)
        assert m["better"] == ("higher" if name.startswith("field.") else "lower")
        assert (FGBENCH / "metrics" / f"{name}.py").is_file()
    assert [m["name"] for m in b["per_layer"][-len(EIGHT):]] == list(EIGHT)
