"""The slice as a whole: the port's `Trainer` against the JAX package's on one
tiny synthetic dataset, the checkpoint round trip, and the `train` /
`train-control` CLI verbs on the CPU.

The two trainers parse the same files and draw the same frames (one seed,
one epoch permutation sequence). The JAX trainer's initial state is carried
across (`train_state_from_jax`) and its step's random draws are handed to the
port's step (`jax_step_draws`), so both take the same steps: the downscale
phase (half resolution at first), the flow batch with camera0, flow and
depth0, the SH schedule, the compositor (the Pallas kernels in interpret
mode on the JAX side, so its absgrad is the per-tile statistic, as the
port's), an f32 8x256 deform field (flax on the JAX side, the port's
split-linear twin); the init's isotropic scales get a seeded anisotropy on
both sides, without which the quaternions' gradient is f32 rounding noise.
Budgets are those of tests/test_torch_train_step.py:
losses and PSNR rtol 1e-5 at the first step, 1e-4 after; Adam moments rtol
1e-3 / atol 1e-3 of the group's largest moment (the deform group's
rotation head takes gradients orders under its largest, where f32
cancellation in the quaternion normalization's gradient leaves relative
differences of ~2e-3); parameters atol 1e-5 + rtol 1e-4
but for at most 2% of a group's entries at the f32 noise floor (2 lr a
step; the deform field is one group). eval_one's
PSNR within rtol 1e-4. The one-step run is in the core gate; the three-step
run (the refine at the third step, the switch to full resolution) is marked
slow.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from freegaussian_tpu.engine.optimizers import OptimizersConfig as JOptimizersConfig
from freegaussian_tpu.engine.trainer import Trainer as JTrainer
from freegaussian_tpu.engine.trainer import TrainerConfig as JTrainerConfig
from freegaussian_tpu.models.densify import DensifyConfig as JDensifyConfig
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu_torch import cli
from freegaussian_tpu_torch.engine import checkpoints
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig
from freegaussian_tpu_torch.engine.train_step import GAUSSIAN_GROUPS
from freegaussian_tpu_torch.engine.trainer import Trainer, TrainerConfig
from freegaussian_tpu_torch.models.densify import DensifyConfig
from freegaussian_tpu_torch.models.splat_model import SplatConfig
from freegaussian_tpu_torch.models.torch_compat import adam_state_from_optax, deform_state_from_flax, train_state_from_jax
from test_data import make_synthetic_dataset
from test_torch_train_step import LR, _assert_params_close
from torch_port_helpers import jax_step_draws

REPO = Path(__file__).resolve().parent.parent
CAPACITY = 160
MODEL = dict(
    warm_up=0, num_downscales=1, resolution_schedule=2, tile_size=32, deform_bf16=False, background_color="random",
    flow_loss_weight=0.01, flow_3d_loss_weight=0.1, flow_px_ref=128, deform_head_init_scale=1e-4,
)
# one refine at step 2; with 6 training frames it culls only (splits and
# duplicates wait for step % (10 * 1) > 6 + 1)
DENSIFY = dict(
    refine_start=2, refine_every=1, reset_alpha_every=10, stop_screen_size_at=0,
    densify_grad_thresh=2e-4, densify_size_thresh=0.06,
)
# the JAX train step's metric keys (freegaussian_tpu/engine/train_step.py:274-286, both flow losses on),
# and the trainer's step and steps_per_sec
TRAIN_KEYS = {"params_finite", "loss", "main_loss", "l1", "ssim", "psnr", "gaussian_count", "num_isects",
              "flow_2d", "flow_3d", "step", "steps_per_sec"}
# the JAX control step's (freegaussian_tpu/engine/control_train_step.py:97-105)
CONTROL_KEYS = {"params_finite", "loss", "main_loss", "psnr", "gaussian_count", "num_isects", "step", "steps_per_sec"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    make_synthetic_dataset(root, n=6, h=32, w=48)
    return root


def _common(data, out, steps):
    return dict(
        data=str(data), dataparser="synthetic", output_dir=str(out), max_num_iterations=steps, steps_per_save=0,
        steps_per_eval_image=0, steps_per_eval_all_images=0, steps_per_log=1, capacity=CAPACITY, num_random=60,
        seed=7, dataparser_kwargs={"interval": 2},
    )


def _trainers(data, tmp_path, steps):
    jcfg = JTrainerConfig(
        **_common(data, tmp_path / "jax", steps), splat=JConfig(backend="pallas", **MODEL),
        densify=JDensifyConfig(**DENSIFY), optimizers=JOptimizersConfig(max_steps=1000),
    )
    tcfg = TrainerConfig(
        **_common(data, tmp_path / "port", steps), splat=SplatConfig(deform_impl="headsfused", **MODEL),
        densify=DensifyConfig(**DENSIFY), optimizers=OptimizersConfig(max_steps=1000),
    )
    jt = JTrainer(jcfg)
    tt = Trainer(tcfg, device="cpu")
    # the init's scales are isotropic, which leaves the quaternions' gradient
    # pure f32 rounding noise: give both sides the same seeded anisotropy
    scales = np.asarray(jt.state.params["scales"])
    scales = scales + np.random.default_rng(1).normal(scale=0.3, size=scales.shape).astype(np.float32) * np.asarray(jt.state.alive)[:, None]
    jt.state = jt.state.replace(params=dict(jt.state.params, scales=jax.numpy.asarray(scales)))
    js = jt.state
    tt.state = train_state_from_jax(
        jax.tree.map(np.asarray, js.params), np.asarray(js.alive), jax.tree.map(np.asarray, js.deform_vars),
        jax.tree.map(np.asarray, js.opt_states),
        {k: np.asarray(getattr(js.densify, k)) for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
        step=0, generator=torch.Generator().manual_seed(0), cfg=tcfg.splat, device="cpu",
    )
    draws = {}
    real = tt.step_fn

    def step_fn(state, camera, batch, sh_degree_now, camera0=None):
        return real(state, camera, batch, sh_degree_now, camera0=camera0, draws=draws["now"])

    tt.step_fn = step_fn
    return jt, tt, draws


def _compare_states(jstate, tstate, steps):
    np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(jstate.alive))
    for k in GAUSSIAN_GROUPS:
        _assert_params_close(k, tstate.params[k].detach().numpy(), np.asarray(jstate.params[k]), LR[k], steps)
    # the deform field as one group: its 8x256 trunk's first layers take
    # gradients at the f32 noise floor, each Adam-normalized to ~lr a step
    want_deform = deform_state_from_flax(jax.tree.map(np.asarray, jstate.deform_vars))
    names = [k for k, _ in tstate.deform.named_parameters()]
    got = np.concatenate([p.detach().numpy().ravel() for _, p in tstate.deform.named_parameters()])
    _assert_params_close("deform", got, np.concatenate([want_deform[k].numpy().ravel() for k in names]), LR["deform"], steps)
    for g, got in tstate.opt_states.items():
        want = adam_state_from_optax(g, jax.tree.map(np.asarray, jstate.opt_states[g]), device="cpu")
        assert got.count == want.count == steps, g
        for part in ("mu", "nu"):
            scale = max(float(w.abs().max()) for w in getattr(want, part).values())  # the group's largest
            for k, w in getattr(want, part).items():
                torch.testing.assert_close(getattr(got, part)[k], w, rtol=1e-3, atol=1e-3 * scale + 1e-12,
                                           msg=f"{g}.{part}.{k}")


def _run(dataset, tmp_path, n_steps):
    jt, tt, draws = _trainers(dataset, tmp_path, n_steps)
    assert set(tt.state.opt_states) == set(jt.state.opt_states) - {"control"}
    for i in range(n_steps):
        draws["now"] = jax_step_draws(jt.state.key, CAPACITY)
        jm = jt.train(1)
        tm = tt.train(1)
        assert set(tm) == set(jm) == TRAIN_KEYS
        rtol = 1e-5 if i == 0 else 1e-4
        for key in ("loss", "main_loss", "l1", "ssim", "psnr", "flow_2d", "flow_3d"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=rtol, atol=1e-7, err_msg=f"step {i} {key}")
        assert tm["step"] == jm["step"] == i and tm["gaussian_count"] == jm["gaussian_count"]
        _compare_states(jt.state, tt.state, i + 1)
    je, te = jt.eval_one(n_steps), tt.eval_one(n_steps)
    assert te["eval_idx"] == je["eval_idx"]
    np.testing.assert_allclose(te["psnr"], je["psnr"], rtol=1e-4)
    np.testing.assert_allclose(te["ssim"], je["ssim"], rtol=1e-3)
    return jt, tt


def test_trainer_matches_jax_one_step(dataset, tmp_path):
    _run(dataset, tmp_path, 1)


@pytest.mark.slow
def test_trainer_matches_jax_three_steps(dataset, tmp_path):
    _run(dataset, tmp_path, 3)


def test_checkpoint_round_trip(dataset, tmp_path):
    """save -> load into a fresh trainer is bit-equal (every tensor, the Adam
    counts, the step, the generator), re-saving a step overwrites it, and
    training on from the loaded state takes the same step as the original."""
    cfg = TrainerConfig(
        **_common(dataset, tmp_path, 2), splat=SplatConfig(deform_impl="headsfused", **MODEL),
        densify=DensifyConfig(**DENSIFY),
    )
    a = Trainer(cfg, device="cpu")
    a.train(2)
    path = a.save(2)
    a.save(2)  # overwrite
    assert sorted(p.name for p in path.iterdir()) == ["2"]
    b = Trainer(dataclasses.replace(cfg, seed=8), device="cpu")
    b.datamanager._epoch_order = list(a.datamanager._epoch_order)
    b.datamanager.rng = a.datamanager.rng
    b.load(path)
    sa, sb = checkpoints.state_dict(a.state), checkpoints.state_dict(b.state)
    flat = lambda d, p="": sum(([(p + k, v)] if not isinstance(v, dict) else flat(v, p + k + ".") for k, v in d.items()), [])
    fa, fb = dict(flat(sa)), dict(flat(sb))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k
    ma, mb = a.train(1), b.train(1)
    assert ma["loss"] == mb["loss"] and ma["step"] == mb["step"] == 2


def _overrides(tmp_path, text):
    p = tmp_path / "over.yaml"
    p.write_text(text)
    return str(p)


def test_cli_train_and_train_control(dataset, tmp_path):
    """`cli.main(["train", ...])` and then `train-control` over its
    checkpoint, on the CPU: each writes metrics.jsonl with the JAX CLI's
    keys and a finite loss, and ends its output with the metrics JSON."""
    import io
    from contextlib import redirect_stdout

    out = tmp_path / "out"
    over = _overrides(tmp_path, f"""
max_num_iterations: 3
capacity: {CAPACITY}
num_random: 60
steps_per_log: 1
steps_per_save: 2
steps_per_eval_image: 2
output_dir: {out}
vis: jsonl
pipeline:
  model:
    warm_up: 0
    num_downscales: 0
""")
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["train", "--data", str(dataset), "--config", str(REPO / "configs/sim/base.yaml"),
                  "--scene-config", over, "--device", "cpu"])
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(last) == TRAIN_KEYS and np.isfinite(last["loss"])
    rows = [json.loads(l) for l in (out / "freegaussian" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train_rows] == [0, 1, 2] and all(set(r) == TRAIN_KEYS for r in train_rows)
    assert any(r.get("eval") == "image" and np.isfinite(r["psnr"]) for r in rows)
    ckpts = out / "freegaussian" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["2", "3"]

    rng = np.random.default_rng(0)
    np.save(dataset / "gaussian_mask_60x2.npy", rng.uniform(size=(60, 2)) < 0.4)
    out2 = tmp_path / "out2"
    over2 = _overrides(tmp_path, f"max_num_iterations: 2\ncapacity: {CAPACITY}\nnum_random: 60\nsteps_per_log: 1\n"
                                 f"output_dir: {out2}\nvis: jsonl\n")
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["train-control", "--data", str(dataset), "--config", str(REPO / "configs/control/sim/base.yaml"),
                  "--scene-config", over2, "--stage1-checkpoint", str(ckpts), "--deform-impl", "pallas",
                  "--device", "cpu"])
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(last) == CONTROL_KEYS and np.isfinite(last["loss"])
    rows = [json.loads(l) for l in (out2 / "freegaussian" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [0, 1]
    saved = checkpoints.read_checkpoint(out2 / "freegaussian" / "checkpoints")
    stage1 = checkpoints.read_checkpoint(ckpts)
    assert saved["step"] == 2 and saved["control"] is not None and set(saved["opt_states"]) == set(GAUSSIAN_GROUPS) | {"control"}
    for k, v in stage1["deform"].items():  # the deform field is frozen in stage 2
        assert torch.equal(saved["deform"][k], v), k


def test_cli_refuses_cuda_without_a_gpu(dataset):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit, match="cuda"):
        cli.main(["train", "--data", str(dataset)])


def test_trainer_viewers_serve_the_live_state(dataset, tmp_path):
    """`start_viewer` over a stage-1 trainer, and over a stage-2 trainer
    started from its checkpoint with a mask file: each answers GET /render
    with a PNG of the requested size; the stage-2 sliders move the frame."""
    import http.client

    from freegaussian_tpu_torch.engine.control_trainer import ControlTrainer
    from freegaussian_tpu_torch.viewer.png import decode_png

    def get(port, path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()
        finally:
            conn.close()

    cfg = TrainerConfig(
        **_common(dataset, tmp_path, 1), splat=SplatConfig(deform_impl="headsfused", **MODEL),
        densify=DensifyConfig(**DENSIFY),
    )
    stage1 = Trainer(cfg, device="cpu")
    ckpt = stage1.save(0)
    mask_path = tmp_path / "gaussian_mask_60x2.npy"
    np.save(mask_path, np.random.default_rng(2).uniform(size=(60, 2)) < 0.5)
    stage2 = ControlTrainer(cfg, load_deformable_checkpoint=ckpt, gaussian_mask_path=mask_path, device="cpu")
    assert stage1.viewer_num_attributes() == 0 and stage2.viewer_num_attributes() == 2
    frames = []
    for trainer, query in ((stage1, ""), (stage2, ""), (stage2, "&atrb=9,0,0,0,9,0")):
        server = trainer.start_viewer(port=0, width=40, height=24)
        try:
            status, ctype, body = get(server.port, "/render?th=0.2&ph=0.1&r=4.5&t=0.3" + query)
        finally:
            server.shutdown()
        assert status == 200 and ctype == "image/png"
        frames.append(decode_png(body))
        assert frames[-1].shape == (24, 40, 3)
    assert not np.array_equal(frames[1], frames[2])
