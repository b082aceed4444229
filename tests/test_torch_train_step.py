"""The port's stage-1 training step against the JAX package's, step by step.

Both start from one state (`train_state_pair`: the same padded parameters,
depth-2 width-32 deform field, optax Adam states and densification
statistics) and take the same steps: the JAX step with
`SplatConfig(backend="pallas")` (the Pallas compositor and its backward in
interpret mode, so its absgrad is the true per-tile statistic), the port's
with its compositor's plain versions on the CPU. The JAX step's random
draws (background, split samples) are handed to the port. Flow losses are
on, warm-up is 0, and the densification schedule puts one refine (splits,
duplicates and culls) at the third step.

Tolerances. Losses and PSNR: rtol 1e-5 at the first step, 1e-4 after it
(the parameters then carry their own budget). Adam moments: the gradient budget (rtol 1e-3,
atol 1e-3 of the group's largest moment: per-Gaussian gradients are sums of
rows of both signs, so the f32 rounding of large rows survives the
cancellation). Parameters: atol 1e-5 + rtol 1e-4, except where a gradient
at the f32 noise floor (1e-9 and below, 4-5 orders under the group's
largest) differs in size or sign between the two: Adam's first steps move
by about lr whatever the gradient's size, so such entries may differ by up
to 2 lr per step taken, and at most 2% of a group's entries may. Alive
masks exactly, densification statistics at rtol 1e-3 / atol 1e-6, after
each step.

The JAX step is jitted once per process (its first call compiles for ~10 s
on the CPU; unjitted, the Pallas interpreter dispatches op by op and a step
takes ~60 s). The three-step run is marked slow; the one-step run is not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.engine.train_step import make_train_step as j_make_train_step
from freegaussian_tpu.models.densify import DensifyConfig as JDensifyConfig
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
from freegaussian_tpu_torch.engine.train_step import GAUSSIAN_GROUPS, make_train_step
from freegaussian_tpu_torch.models.densify import DensifyConfig
from freegaussian_tpu_torch.models.splat_model import SplatConfig
from freegaussian_tpu_torch.models.torch_compat import adam_state_from_optax, deform_state_from_flax
from torch_port_helpers import camera_arrays, jax_camera, jax_step_draws, torch_camera, train_state_pair

W, H = 48, 32
MODEL = dict(
    warm_up=0, tile_size=32, deform_bf16=False, background_color="random",
    flow_loss_weight=0.01, flow_3d_loss_weight=0.1, flow_px_ref=128,
)
# one refine at step 2: refine_start 2, every step; step % (10 * 1) = 2 > 0 + 1
DENSIFY = dict(
    refine_start=2, refine_every=1, reset_alpha_every=10, stop_screen_size_at=0,
    densify_grad_thresh=2e-4, densify_size_thresh=0.06,
)
# per-step learning rates (OptimizersConfig(max_steps=1000) defaults)
LR = {"means": 8e-4, "scales": 5e-3, "quats": 1e-3, "features_dc": 2.5e-3, "features_rest": 1.25e-4,
      "opacities": 0.05, "deform": 8e-4}


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.uniform(size=(H, W, 3)).astype(np.float32),
        "flow": rng.normal(scale=1.5, size=(H, W, 2)).astype(np.float32),
        "depth0": rng.uniform(3.0, 5.0, size=(H, W, 1)).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def _jax_step(field, j_opts_key):
    """The JAX step, jitted once per process (the state, not the step, carries
    the step count, so the refine schedule is traced, as in the trainer)."""
    j_opts = _JAX_OPTIMIZERS[j_opts_key]
    step = j_make_train_step(
        JConfig(backend="pallas", **MODEL), JDensifyConfig(**DENSIFY), j_opts, field.apply,
        num_train_data=0, jit=False,
    )
    return jax.jit(step, static_argnames=("sh_degree_now",))


_JAX_OPTIMIZERS = {}


def _setup():
    jstate, tstate, field, j_opts = train_state_pair(n=150, capacity=180, seed=5)
    _JAX_OPTIMIZERS.setdefault("default", j_opts)
    j_step = _jax_step(field, "default")
    t_step = make_train_step(
        SplatConfig(**MODEL), DensifyConfig(**DENSIFY), make_optimizers(OptimizersConfig(max_steps=1000)), 0
    )
    cams = [camera_arrays(time=0.6), camera_arrays(eye=(0.7, 0.55, 4.1), time=0.45)]
    return jstate, tstate, j_step, t_step, cams


def _assert_params_close(name, got, want, lr, steps):
    got, want = np.asarray(got), np.asarray(want)
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    flipped = ~close
    assert flipped.mean() <= 0.02, f"{name}: {flipped.sum()} of {flipped.size} entries differ"
    np.testing.assert_array_less(np.abs(got - want)[flipped], 2 * lr * steps + 1e-5, err_msg=name)


def _compare(jstate, tstate, steps):
    np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(jstate.alive))
    for k in GAUSSIAN_GROUPS:
        _assert_params_close(k, tstate.params[k].detach().numpy(), jstate.params[k], LR[k], steps)
    want_deform = deform_state_from_flax(jax.tree.map(np.asarray, jstate.deform_vars))
    for k, p in tstate.deform.named_parameters():
        _assert_params_close(k, p.detach().numpy(), want_deform[k].numpy(), LR["deform"], steps)
    for g, st in jstate.opt_states.items():
        want = adam_state_from_optax(g, jax.tree.map(np.asarray, st), device="cpu")
        got = tstate.opt_states[g]
        assert got.count == want.count == steps, g
        for part in ("mu", "nu"):
            for k, w in getattr(want, part).items():
                scale = float(w.abs().max())
                torch.testing.assert_close(getattr(got, part)[k], w, rtol=1e-3, atol=1e-3 * scale + 1e-12,
                                           msg=f"{g}.{part}.{k}")
    for k in ("xys_grad_norm", "vis_counts", "max_2dsize"):
        np.testing.assert_allclose(getattr(tstate.densify, k).numpy(), np.asarray(getattr(jstate.densify, k)),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def _run(n_steps):
    jstate, tstate, j_step, t_step, cams = _setup()
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    jcam, jcam0 = jax_camera(cams[0]), jax_camera(cams[1])
    tcam, tcam0 = torch_camera(cams[0]), torch_camera(cams[1])
    refines = []
    for i in range(n_steps):
        draws = jax_step_draws(jstate.key, 180)
        jstate, jm = j_step(jstate, jcam, jbatch, 3, camera0=jcam0)
        tstate, tm = t_step(tstate, tcam, tbatch, 3, camera0=tcam0, draws=draws)
        assert bool(tm["params_finite"]) and bool(jm["params_finite"])
        for key in ("loss", "main_loss", "l1", "ssim", "psnr", "flow_2d", "flow_3d"):
            # from the second step on, the inputs carry the parameters' 1e-4 budget
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5 if i == 0 else 1e-4, atol=1e-7,
                                       err_msg=key)
        assert int(tm["gaussian_count"]) == int(jm["gaussian_count"])
        _compare(jstate, tstate, i + 1)
        if "refine" in tm:
            refines.append({k: int(v) for k, v in tm["refine"].items()})
    return refines


@pytest.mark.slow
def test_train_step_matches_jax_three_steps_with_refine():
    refines = _run(3)
    assert len(refines) == 1
    r = refines[0]
    assert r["num_split"] > 0 and r["num_dup"] > 0 and r["num_culled"] > 0, r


def test_train_step_matches_jax_one_step():
    assert _run(1) == []  # the refine comes at step 2


def test_train_step_refuses_unported_options():
    opts = make_optimizers(OptimizersConfig())
    with pytest.raises(NotImplementedError, match="camera"):
        make_train_step(SplatConfig(camera_optimizer_mode="SO3xR3"), DensifyConfig(), opts, 1)
    with pytest.raises(NotImplementedError, match="bilateral"):
        make_train_step(SplatConfig(use_bilateral_grid=True), DensifyConfig(), opts, 1)
    with pytest.raises(NotImplementedError, match="camera"):
        make_train_step(SplatConfig(), DensifyConfig(), opts, 1, train_camera_opt=True)


def test_train_step_draws_from_the_state_generator():
    """Without injected draws the random background and split samples come
    from `state.generator`: two states seeded alike take identical steps."""
    outs = []
    for _ in range(2):
        _, tstate, _, t_step, cams = _setup()
        tstate.step = 2  # the refine step of DENSIFY
        batch = {k: torch.tensor(v) for k, v in _batch().items()}
        tstate, m = t_step(tstate, torch_camera(cams[0]), batch, 3, camera0=torch_camera(cams[1]))
        outs.append((float(m["loss"]), tstate.params["means"].detach().clone(), tstate.alive.clone()))
    assert outs[0][0] == outs[1][0]
    assert torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2])
