"""The chunked training loop (`TrainerConfig.scan_chunk`) and the
intersection-capacity self-tuner, on the CPU, on the tiny synthetic dataset
of tests/test_engine.py (6 frames of 32 x 32).

On the CPU the chunk runner runs its steps eagerly through the same device
tables the card's graphs read, so:
  - `scan_chunk` 1 (the chunk loop with one step a chunk) equals the
    per-step loop bit for bit, in stage 1 with refinement and in stage 2;
  - `scan_chunk` 5 matches the JAX trainer's `lax.scan` chunks from the
    same initial state: the same logged steps and eval rows, losses and
    PSNR at test_torch_trainer.py's budget after the first step (rtol 1e-4).
    Both render over a black background (no random draws to hand across);
    the JAX side composites with its dense oracle (`backend="reference"`, as
    its own scan test does, for a short compile), whose image the tile
    compositor matches to f32 rounding (tests/test_torch_rasterize.py);
  - the capacity tuner takes the JAX trainer's decisions on the same
    readings, and shrinks 2^15 to 2^14 in training as
    tests/test_engine.py:test_isect_capacity_auto_shrink does;
  - a non-finite loss inside a chunk halts with its step;
  - a YAML `scan_chunk:` and `isect_capacity:` reach the configs."""

import contextlib
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.engine.control_trainer import ControlTrainer as JControlTrainer
from freegaussian_tpu.engine.optimizers import OptimizersConfig as JOptimizersConfig
from freegaussian_tpu.engine.trainer import Trainer as JTrainer
from freegaussian_tpu.engine.trainer import TrainerConfig as JTrainerConfig
from freegaussian_tpu.models.densify import DensifyConfig as JDensifyConfig
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu_torch.engine import checkpoints
from freegaussian_tpu_torch.engine.config import trainer_config_from_yaml
from freegaussian_tpu_torch.engine.control_trainer import ControlTrainer
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig
from freegaussian_tpu_torch.engine.trainer import Trainer, TrainerConfig
from freegaussian_tpu_torch.models.densify import DensifyConfig
from freegaussian_tpu_torch.models.splat_model import SplatConfig
from freegaussian_tpu_torch.models.torch_compat import train_state_from_jax
from test_data import make_synthetic_dataset

REPO = Path(__file__).resolve().parent.parent
MODEL = dict(
    warm_up=1, num_downscales=1, resolution_schedule=3, tile_size=16, deform_bf16=False, background_color="black",
    flow_loss_weight=0.01, flow_3d_loss_weight=0.01, deform_head_init_scale=1e-4,
)
NO_REFINE = dict(refine_start=10**9)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    make_synthetic_dataset(root, n=6, h=32, w=32)
    return root


def _common(data, out, chunk, **kw):
    return {
        **dict(
            data=str(data), dataparser="synthetic", output_dir=str(out), capacity=128, num_random=50, steps_per_save=0,
            steps_per_eval_image=0, steps_per_eval_all_images=4, eval_all_max_images=1, steps_per_log=2, seed=3,
            scan_chunk=chunk, dataparser_kwargs={"interval": 2},
        ),
        **kw,
    }


def _port(data, out, chunk, model=None, densify=None, **kw):
    cfg = TrainerConfig(
        **_common(data, out, chunk, **kw), splat=SplatConfig(deform_impl="headsfused", **(model or MODEL)),
        densify=DensifyConfig(**(densify or NO_REFINE)), optimizers=OptimizersConfig(max_steps=100),
    )
    return Trainer(cfg, device="cpu")


def _rows(trainer):
    return [json.loads(line) for line in (trainer.out_dir / "metrics.jsonl").read_text().splitlines()]


def _flat(state):
    d = checkpoints.state_dict(state)
    out = {}

    def walk(x, p):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{p}.{k}")
        else:
            out[p] = x

    walk(d, "")
    return out


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def _without_timing(rows):
    return [{k: v for k, v in r.items() if k not in ("steps_per_sec", "num_rays_per_sec", "fps")} for r in rows]


def test_chunk_of_one_equals_the_per_step_loop(dataset, tmp_path):
    """Random background (the generator's draws), warm-up switch, downscale
    phase change and one refinement: the chunk loop and the per-step loop
    take the same steps, state and logs bit for bit."""
    model = dict(MODEL, background_color="random")
    densify = dict(refine_start=4, refine_every=4, densify_grad_thresh=1e-6)
    loop = _port(dataset, tmp_path / "loop", 0, model, densify)
    chunked = _port(dataset, tmp_path / "chunk", 1, model, densify)
    loop.train(6)
    chunked._train_scan(6)
    _assert_states_equal(loop.state, chunked.state)
    assert _without_timing(_rows(loop)) == _without_timing(_rows(chunked))


def _pair(data, tmp_path, chunk, model, **kw):
    """A JAX trainer and the port's, from the JAX trainer's initial state."""
    jt = JTrainer(JTrainerConfig(
        **_common(data, tmp_path / "jax", chunk, **kw), splat=JConfig(**{**model, "backend": "reference"}),
        densify=JDensifyConfig(**NO_REFINE), optimizers=JOptimizersConfig(max_steps=100),
    ))
    tt = _port(data, tmp_path / "port", chunk, model, **kw)
    js = jt.state
    tt.state = train_state_from_jax(
        jax.tree.map(np.asarray, js.params), np.asarray(js.alive), jax.tree.map(np.asarray, js.deform_vars),
        jax.tree.map(np.asarray, js.opt_states),
        {k: np.asarray(getattr(js.densify, k)) for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
        step=0, generator=torch.Generator().manual_seed(0), cfg=tt.config.splat, device="cpu",
    )
    tt._rebuild_step_fn()
    return jt, tt


def _assert_logs_match(jrows, trows, first_chunk):
    jtrain = {r["step"]: r for r in jrows if "eval" not in r}
    ttrain = {r["step"]: r for r in trows if "eval" not in r}
    assert set(jtrain) == set(ttrain)
    for s, r in jtrain.items():
        # test_torch_trainer.py's budget (1e-5 at the first step, 1e-4 after)
        # over the first chunk; past it 1e-3: Adam turns the two packages'
        # f32 rounding into lr-scale noise on parameters with ~zero
        # gradients, which feeds back into the loss (the JAX package's own
        # chunk-vs-loop test allows 0.02 after 8 steps)
        rtol = 1e-5 if s == 0 else 1e-4 if s < first_chunk else 1e-3
        for key in ("loss", "main_loss", "psnr"):
            np.testing.assert_allclose(ttrain[s][key], r[key], rtol=rtol, err_msg=f"step {s} {key}")
    jev = [(r["step"], r["eval"]) for r in jrows if "eval" in r]
    assert jev == [(r["step"], r["eval"]) for r in trows if "eval" in r] and jev
    for a, b in zip((r for r in jrows if "eval" in r), (r for r in trows if "eval" in r)):
        np.testing.assert_allclose(b["psnr"], a["psnr"], rtol=1e-4)


def test_chunk_of_five_matches_jax_train_scan(dataset, tmp_path):
    """10 steps in two chunks of 5, the eval cadence at their ends (one
    chunk shape: one JAX compile; the downscale phase's chunk break is the
    chunk-of-one test's): the logged steps, the losses and the eval rows of
    the JAX trainer's chunks."""
    jt, tt = _pair(dataset, tmp_path, 5, dict(MODEL, num_downscales=0), steps_per_eval_all_images=5)
    jt.train(10)
    tt.train(10)
    assert int(jt.state.step) == tt.state.step == 10
    _assert_logs_match(_rows(jt), _rows(tt), 5)


def test_refinement_inside_a_chunk(dataset, tmp_path):
    """Refinement at its cadence steps inside a chunk (the JAX test's
    window: it opens after step 8 with 6 frames and refine_every 2): the
    Gaussian count moves, and the chunked run equals the per-step loop."""
    densify = dict(refine_start=2, refine_every=2, densify_grad_thresh=1e-6)
    chunked = _port(dataset, tmp_path / "chunk", 6, densify=densify, steps_per_log=1)
    loop = _port(dataset, tmp_path / "loop", 0, densify=densify, steps_per_log=1)
    chunked.train(14)
    loop.train(14)
    counts = [r["gaussian_count"] for r in _rows(chunked) if "gaussian_count" in r]
    assert counts[-1] != counts[0], counts
    _assert_states_equal(loop.state, chunked.state)


def test_capacity_tuner_takes_the_jax_decisions(dataset, tmp_path):
    """The same readings into both trainers' tuners, with the step moving as
    in training: overflow and doubling, the 10-reading low streak, the shrink
    to 1.35x the recent maximum, the 1500-step cooldown, the 2^14 floor."""
    jt = JTrainer(JTrainerConfig(
        **_common(dataset, tmp_path / "jax", 0), splat=JConfig(backend="reference", **MODEL),
        densify=JDensifyConfig(**NO_REFINE),
    ))
    tt = _port(dataset, tmp_path / "port", 0)
    assert jt._isect_capacity() == tt._isect_capacity() == 1 << 14
    readings = [20000, 30000, 9000] + [5000] * 12 + [40000, 90000] + [3000] * 11 + [20000] * 3
    step = 0
    decisions = []
    for r in readings:
        step += 200
        jt.state = jt.state.replace(step=jnp.asarray(step))
        tt.state.step = step
        with pytest.warns(UserWarning, match="overflow") if r > tt._isect_capacity() else contextlib.nullcontext():
            tt._maybe_grow_isect_capacity({"num_isects": r})
        with pytest.warns(UserWarning, match="overflow") if r > jt._isect_capacity() else contextlib.nullcontext():
            jt._maybe_grow_isect_capacity({"num_isects": jnp.asarray(r)})
        decisions.append((jt._isect_capacity(), tt._isect_capacity()))
    assert all(a == b for a, b in decisions), decisions
    assert jt._isect_shrinks == tt._isect_shrinks >= 1
    assert len({c for c, _ in decisions}) >= 3  # grew and shrank


def test_capacity_shrinks_in_chunked_training(dataset, tmp_path):
    """tests/test_engine.py:test_isect_capacity_auto_shrink through the
    chunk loop: 2^15 slots, ten low readings (chunk peaks) shrink it to
    the 2^14 floor once."""
    tt = _port(dataset, tmp_path / "port", 2, steps_per_log=1, steps_per_eval_all_images=0)
    tt.config = dataclasses.replace(tt.config, splat=dataclasses.replace(tt.config.splat, isect_capacity=1 << 15))
    tt._rebuild_step_fn()
    tt.train(20)
    assert tt.config.splat.isect_capacity == 1 << 14 and tt._isect_shrinks == 1


def test_nan_inside_a_chunk_halts_with_its_step(dataset, tmp_path):
    tt = _port(dataset, tmp_path / "port", 5, steps_per_eval_all_images=0)
    arena = tt._device_dataset(2)  # the first phase's frames
    order = list(tt.datamanager.rng.permutation(6))  # the first epoch, as draw_indices pops it
    tt.datamanager.rng = np.random.default_rng(tt.config.seed)
    bad_frame = order[-3]  # drawn at step 2
    arena.batch["image"][bad_frame] = float("nan")
    with pytest.raises(FloatingPointError, match=r"chunk \[0, 3\) \(first at step 2\)"):
        tt.train(5)


def _mask(dataset, live=50, m=2):
    """A seeded (live, M) cluster mask over the 50 random Gaussians."""
    path = dataset / f"gaussian_mask_{live}x{m}.npy"
    if not path.exists():
        np.save(path, np.random.default_rng(0).uniform(size=(live, m)) < 0.4)
    return path


def test_stage2_chunks(dataset, tmp_path):
    """Stage 2 under `scan_chunk`: the chunk of one equals the per-step loop
    bit for bit; chunks of 3 match the JAX control trainer's chunks from the
    same state, 6 steps with the eval cadence at 3 (losses and PSNR, the
    budgets of `_assert_logs_match`)."""
    mask = _mask(dataset)
    model = dict(MODEL, flow_loss_weight=0.0, flow_3d_loss_weight=0.0, deform_impl="headsfused")

    def port(out, chunk):
        cfg = TrainerConfig(
            **_common(dataset, tmp_path / out, chunk, steps_per_eval_all_images=3), splat=SplatConfig(**model),
            densify=DensifyConfig(**NO_REFINE), optimizers=OptimizersConfig(max_steps=100),
        )
        return ControlTrainer(cfg, gaussian_mask_path=mask, device="cpu")

    loop, one = port("loop", 0), port("one", 1)
    loop.train(4)
    one._train_scan(4)
    _assert_states_equal(loop.state, one.state)
    assert _without_timing(_rows(loop)) == _without_timing(_rows(one))

    jmodel = {k: v for k, v in model.items() if k != "deform_impl"}
    jt = JControlTrainer(
        JTrainerConfig(**_common(dataset, tmp_path / "jax", 3, steps_per_eval_all_images=3),
                       splat=JConfig(backend="reference", **jmodel),
                       densify=JDensifyConfig(**NO_REFINE), optimizers=JOptimizersConfig(max_steps=100)),
        gaussian_mask_path=mask,
    )
    tt = port("port", 3)
    js = jt.state
    st = train_state_from_jax(
        jax.tree.map(np.asarray, js.params), np.asarray(js.alive), jax.tree.map(np.asarray, js.deform_vars),
        {g: jax.tree.map(np.asarray, s) for g, s in js.opt_states.items() if g in tt.state.opt_states},
        {k: np.asarray(getattr(js.densify, k)) for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
        step=0, generator=torch.Generator().manual_seed(0), cfg=tt.config.splat, control_vars_np=jax.tree.map(np.asarray, js.control_vars), device="cpu",
    )
    st.deform.requires_grad_(False)
    tt.state = st
    tt._rebuild_step_fn()
    jt.train(6)
    tt.train(6)
    _assert_logs_match(_rows(jt), _rows(tt), 3)


def test_yaml_scan_chunk_and_capacity_reach_the_config(tmp_path):
    """A YAML `scan_chunk:` and `pipeline.model.isect_capacity:` land in the
    port's TrainerConfig as in the JAX package's."""
    from freegaussian_tpu.engine.config import trainer_config_from_yaml as j_from_yaml

    over = tmp_path / "over.yaml"
    over.write_text("scan_chunk: 5\npipeline:\n  model:\n    isect_capacity: 4096\n")
    base = REPO / "configs/sim/base.yaml"
    t, j = trainer_config_from_yaml(base, over), j_from_yaml(base, over)
    assert t.scan_chunk == j.scan_chunk == 5
    assert t.splat.isect_capacity == j.splat.isect_capacity == 4096
