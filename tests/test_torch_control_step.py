"""The port's stage-2 training step (`engine/control_train_step.py`) against
the JAX package's `make_control_train_step`, one step from one state.

Both start from the same padded Gaussians (a few dead rows), cluster mask,
f32 depth-2 deform field, f32 8x256 control field (heads x 0.1) and fresh
Adam states (`train_state_from_jax` with the control variables), and take
one step on the same image with the JAX step's random background. The JAX
step renders with its pure-jnp reference compositor and its control field is
the flax f32 path; the port's runs its plain compositor and the f32
split-linear control field on the CPU.

Time: each `train_gaussians` case takes 10-15 s on the CPU with a cold XLA
cache and 3-7 s with a warm one, of which ~8-9 s are the JAX step's trace
(2-2.7 s) and XLA compile (5-6 s). Un-jitted (`jit=False`, op by op) the
first case takes ~40 s; the two cases cannot share one compile, since
`train_gaussians` is a static Python flag of the JAX step.

Tolerances: the loss, main loss and PSNR rtol 1e-5; every group's Adam
moments the gradient budget of tests/test_torch_train_step.py (rtol 1e-3,
atol 1e-3 of the group's largest moment).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.engine.control_train_step import make_control_train_step as j_make_step
from freegaussian_tpu.engine.optimizers import OptimizersConfig as JOptimizersConfig
from freegaussian_tpu.engine.optimizers import init_opt_states as j_init_opt_states
from freegaussian_tpu.engine.optimizers import make_optimizers as j_make_optimizers
from freegaussian_tpu.engine.train_step import GAUSSIAN_GROUPS, TrainState
from freegaussian_tpu.models.densify import DensifyState
from freegaussian_tpu.models.fields import ControlField as JControlField
from freegaussian_tpu.models.fields import DeformField as JDeformField
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu_torch.engine.control_train_step import make_control_train_step
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
from freegaussian_tpu_torch.engine.train_step import create_train_state
from freegaussian_tpu_torch.models.splat_model import SplatConfig
from freegaussian_tpu_torch.models.torch_compat import adam_state_from_optax, train_state_from_jax
from torch_port_helpers import camera_arrays, field_shapes, flax_linear_vars, gaussian_scene_3d, jax_camera, torch_camera

W, H, M = 96, 64, 3
INIT_TIME = 0.2
MODEL = dict(warm_up=0, background_color="random")
J_DEFORM = JDeformField(depth=2, width=32)


def _scene(seed=0, n=200, capacity=216):
    params, alive = gaussian_scene_3d(n=n, seed=seed, capacity=capacity)
    alive = alive.copy()
    alive[5:9] = False
    rng = np.random.default_rng(seed + 100)
    mask = rng.uniform(size=(capacity, M)) < 0.35
    mask[:3] = False
    dvars = flax_linear_vars(rng, field_shapes("deform", depth=2, width=32), [1.0] * 4 + [0.3] * 4)
    cvars = flax_linear_vars(rng, field_shapes("control"), [1.0] * 8 + [0.1] * 3)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    return params, alive, mask, dvars, cvars, image


@functools.lru_cache(maxsize=None)
def _jax_step(train_gaussians, mask_bytes):
    mask = jnp.asarray(np.frombuffer(mask_bytes, bool).reshape(-1, M))
    step = j_make_step(
        JConfig(backend="reference", **MODEL), j_make_optimizers(JOptimizersConfig(max_steps=1000)), JControlField().apply,
        J_DEFORM.apply, mask, INIT_TIME, train_gaussians=train_gaussians, jit=False,
    )
    return jax.jit(step, static_argnames=("sh_degree_now",))


def _states(params, alive, dvars, cvars, seed):
    optimizers = j_make_optimizers(JOptimizersConfig(max_steps=1000))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    groups = {k: jparams[k] for k in GAUSSIAN_GROUPS}
    groups["control"] = cvars
    jstate = TrainState(
        params=jparams, alive=jnp.asarray(alive), deform_vars=dvars, control_vars=cvars,
        opt_states=j_init_opt_states(optimizers, groups), densify=DensifyState.create(len(alive)),
        step=jnp.asarray(0), key=jax.random.PRNGKey(seed),
    )
    tstate = train_state_from_jax(
        params, alive, dvars, jax.tree.map(np.asarray, jstate.opt_states),
        {k: np.asarray(getattr(jstate.densify, k)) for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
        step=0, generator=torch.Generator().manual_seed(seed), cfg=SplatConfig(deform_bf16=False, deform_impl="headsfused"),
        control_vars_np=cvars, device="cpu",
    )
    return jstate, tstate


@pytest.mark.parametrize("train_gaussians", [True, False], ids=["gaussians", "control-only"])
def test_control_step_matches_jax(train_gaussians):
    params, alive, mask, dvars, cvars, image = _scene(seed=3)
    jstate, tstate = _states(params, alive, dvars, cvars, seed=4)
    assert set(tstate.opt_states) == set(GAUSSIAN_GROUPS) | {"control"}
    cam = camera_arrays(width=W, height=H, focal=80.0, time=0.65)
    # the JAX step's background: uniform(split(key)[1]) (a two-way split, unlike the stage-1 step)
    draws = {"background": torch.tensor(np.asarray(jax.random.uniform(jax.random.split(jstate.key)[1], (3,))))}

    jstate, jm = _jax_step(train_gaussians, mask.tobytes())(jstate, jax_camera(cam), {"image": jnp.asarray(image)}, 3)
    step = make_control_train_step(
        SplatConfig(**MODEL), make_optimizers(OptimizersConfig(max_steps=1000)), torch.tensor(mask), INIT_TIME,
        train_gaussians=train_gaussians,
    )
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    tstate, tm = step(tstate, torch_camera(cam), {"image": torch.tensor(image)}, 3, draws=draws)

    assert bool(tm["params_finite"]) and bool(jm["params_finite"])
    assert set(tm) == set(jm)
    for key in ("loss", "main_loss", "psnr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-7, err_msg=key)
    assert int(tm["gaussian_count"]) == int(jm["gaussian_count"]) == int(alive.sum())
    assert tstate.step == 1
    for g, st in jstate.opt_states.items():
        want = adam_state_from_optax(g, jax.tree.map(np.asarray, st), device="cpu")
        got = tstate.opt_states[g]
        assert got.count == want.count == (1 if (train_gaussians or g == "control") else 0), g
        for part in ("mu", "nu"):
            for k, w in getattr(want, part).items():
                scale = float(w.abs().max())
                torch.testing.assert_close(getattr(got, part)[k], w, rtol=1e-3, atol=1e-3 * scale + 1e-12,
                                           msg=f"{g}.{part}.{k}")
    if train_gaussians:
        moved = (tstate.params["means"] - before["means"]).abs().sum(1) > 0
        assert bool(moved[torch.tensor(alive)].all()) and not bool(moved[~torch.tensor(alive)].any())  # dead slots stay
    else:
        for k, v in tstate.params.items():
            assert torch.equal(v.detach(), before[k]), k


def test_create_train_state_freezes_the_deform_field():
    """Stage 2 from fresh: Gaussian groups and "control", no deform group."""
    params, alive, _, dvars, cvars, _ = _scene(seed=5, n=40, capacity=40)
    _, tstate = _states(params, alive, dvars, cvars, seed=6)
    fresh = create_train_state(
        tstate.params, tstate.alive, tstate.deform, make_optimizers(OptimizersConfig()),
        generator=torch.Generator().manual_seed(0), control=tstate.control,
    )
    assert set(fresh.opt_states) == set(GAUSSIAN_GROUPS) | {"control"} and fresh.control is tstate.control
    assert all(st.count == 0 for st in fresh.opt_states.values())
