"""The port's losses, flow ops, schedules and Adam against the JAX package.

Same seeded numpy inputs through both; values and gradients. Tolerances:
rtol 1e-5 / atol 1e-6 on values (f32 rounding in another summation order),
rtol 1e-4 / atol 1e-7 on gradients, unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from freegaussian_tpu.engine import optimizers as j_opt
from freegaussian_tpu.models import splat_model as j_model
from freegaussian_tpu.models.ssim import ssim as j_ssim
from freegaussian_tpu.ops import flow as j_flow
from freegaussian_tpu.ops.math import bilinear_interp as j_bilinear
from freegaussian_tpu.ops.math import exponential_decay_schedule as j_schedule
from freegaussian_tpu_torch.engine import optimizers as t_opt
from freegaussian_tpu_torch.models import splat_model as t_model
from freegaussian_tpu_torch.models.ssim import ssim as t_ssim
from freegaussian_tpu_torch.ops import flow as t_flow
from freegaussian_tpu_torch.ops.math import bilinear_interp as t_bilinear
from freegaussian_tpu_torch.ops.math import exponential_decay_schedule as t_schedule
from torch_port_helpers import camera_arrays, jax_camera, torch_camera

H, W = 32, 48


def _f32(*shape, low=0.0, high=1.0, seed=0):
    return np.random.default_rng(seed).uniform(low, high, size=shape).astype(np.float32)


def _grads_match(t_fn, j_fn, arrays, rtol=1e-4, atol=1e-7):
    """Value and gradient of a scalar function of `arrays` in both packages."""
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    t_val = t_fn(*leaves)
    t_grads = torch.autograd.grad(t_val, leaves, allow_unused=True)
    j_val, j_grads = jax.jit(jax.value_and_grad(j_fn, argnums=tuple(range(len(arrays)))))(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5, atol=1e-6)
    for i, (a, b) in enumerate(zip(t_grads, j_grads)):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()  # unused: JAX's zero gradient
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=f"grad {i}")


@pytest.mark.parametrize("shape", [(H, W, 3), (9, 14, 3)])
def test_ssim_value_and_gradient(shape):
    """(9, 14) is smaller than the window: it is clamped to 9 (odd)."""
    a, b = _f32(*shape, seed=1), _f32(*shape, seed=2)
    b = (0.6 * a + 0.4 * b).astype(np.float32)
    _grads_match(t_ssim, j_ssim, [a, b])


def test_rendered_flow_loss():
    flow, target, alpha = _f32(H, W, 2, low=-3, high=3, seed=3), _f32(H, W, 2, low=-3, high=3, seed=4), _f32(H, W, 1, seed=5)
    _grads_match(t_flow.rendered_flow_loss, j_flow.rendered_flow_loss, [flow, target, alpha])
    # alpha is a weight, not a path for the gradient
    leaves = [torch.tensor(a, requires_grad=True) for a in (flow, target, alpha)]
    g = torch.autograd.grad(t_flow.rendered_flow_loss(*leaves), leaves[2], allow_unused=True)[0]
    assert g is None


def test_bilinear_interp():
    img = _f32(2, H, W, 3, seed=6)
    x = _f32(2, 50, low=-2, high=W + 2, seed=7)
    y = _f32(2, 50, low=-2, high=H + 2, seed=8)
    x[0, :3] = [0.0, 5.0, W - 1.0]  # integer coordinates: the standard weights, not the reference quirk
    got = t_bilinear(torch.tensor(img), torch.tensor(x), torch.tensor(y)).numpy()
    want = np.asarray(j_bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_query_3d_flow_and_supervision_loss():
    arrs, arrs0 = camera_arrays(), camera_arrays(eye=(0.6, 0.4, 4.2), time=0.2)
    tc0, jc0 = torch_camera(arrs0), jax_camera(arrs0)
    tc, jc = torch_camera(arrs), jax_camera(arrs)
    np.testing.assert_allclose(tc0.c2w_opencv.numpy(), np.asarray(jc0.c2w_opencv), atol=0)
    means2d = _f32(60, 2, low=-5, high=W + 5, seed=9)
    means2d[:, 1] *= H / W
    depth0 = _f32(H, W, 1, low=2, high=6, seed=10)
    flow = _f32(H, W, 2, low=-2, high=2, seed=11)
    valid = np.arange(60) % 7 != 0
    t_lift = t_flow.query_3d_gaussian_flow(
        torch.tensor(means2d), torch.tensor(depth0), torch.tensor(flow), tc0.c2w_opencv, tc.K, valid=torch.tensor(valid)
    )
    j_lift = j_flow.query_3d_gaussian_flow(
        jnp.asarray(means2d), jnp.asarray(depth0), jnp.asarray(flow), jc0.c2w_opencv, jc.K, valid=jnp.asarray(valid)
    )
    np.testing.assert_array_equal(t_lift["valid"].numpy(), np.asarray(j_lift["valid"]))
    np.testing.assert_allclose(t_lift["p_world"].numpy(), np.asarray(j_lift["p_world"]), rtol=1e-5, atol=1e-5)
    assert 0 < t_lift["valid"].sum() < 60

    radii = (np.arange(60) % 5).astype(np.int32)
    alive = np.arange(60) % 11 != 0
    means_prev = _f32(60, 3, low=-1, high=1, seed=12)
    t_loss = lambda m: t_flow.flow_supervision_loss(m, t_lift, torch.tensor(radii), alive=torch.tensor(alive))
    j_loss = lambda m: j_flow.flow_supervision_loss(m, j_lift, jnp.asarray(radii), alive=jnp.asarray(alive))
    _grads_match(t_loss, j_loss, [means_prev])


def test_exponential_decay_schedule():
    for args in ((8e-4, 8e-6, 30000, 0, 1e-8), (1e-4, 5e-7, 30000, 1000, 1e-12)):
        t_s, j_s = t_schedule(*args), j_schedule(*args)
        for step in (0, 1, 2, 17, 999, 1000, 1001, 15000, 29999, 30000, 40000):
            np.testing.assert_allclose(float(t_s(step)), float(j_s(step)), rtol=1e-6, err_msg=f"{args} @ {step}")


def _model_outputs(seed=13, rgba=False):
    rng = np.random.default_rng(seed)
    c = 4 if rgba else 3
    return {
        "rgb": rng.uniform(size=(H, W, 3)).astype(np.float32),
        "background": rng.uniform(size=3).astype(np.float32),
    }, {
        "image": rng.uniform(size=(H, W, c)).astype(np.float32),
        "mask": (rng.uniform(size=(H, W, 1)) > 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("rgba,scale_reg", [(False, False), (True, True)])
def test_loss_fn_and_psnr(rgba, scale_reg):
    outputs, batch = _model_outputs(rgba=rgba)
    scales = np.log(_f32(40, 3, low=0.001, high=0.2, seed=14))
    alive = np.arange(40) % 6 != 0
    kw = dict(use_scale_regularization=scale_reg, max_gauss_ratio=3.0, ssim_lambda=0.2)
    t_cfg, j_cfg = t_model.SplatConfig(**kw), j_model.SplatConfig(**kw)

    def t_fn(rgb, sc):
        out = t_model.loss_fn(
            t_cfg, dict(rgb=rgb, background=torch.tensor(outputs["background"])),
            {k: torch.tensor(v) for k, v in batch.items()}, {"scales": sc}, torch.tensor(alive), apply_scale_reg=True,
        )
        return out["main_loss"] + out["scale_reg"]

    def j_fn(rgb, sc):
        out = j_model.loss_fn(
            j_cfg, dict(rgb=rgb, background=jnp.asarray(outputs["background"])),
            {k: jnp.asarray(v) for k, v in batch.items()}, {"scales": sc}, jnp.asarray(alive), apply_scale_reg=True,
        )
        return out["main_loss"] + out["scale_reg"]

    _grads_match(t_fn, j_fn, [outputs["rgb"], scales])
    got = t_model.psnr(torch.tensor(outputs["rgb"]), torch.tensor(batch["image"][..., :3]))
    np.testing.assert_allclose(float(got), float(j_model.psnr(jnp.asarray(outputs["rgb"]), jnp.asarray(batch["image"][..., :3]))), rtol=1e-6)


def test_downscale_factor_and_background():
    cfg, jcfg = t_model.SplatConfig(), j_model.SplatConfig()
    for step in (0, 2999, 3000, 6000, 9000, 100000):
        for train in (True, False):
            assert t_model.downscale_factor(cfg, step, train) == j_model.downscale_factor(jcfg, step, train)
    from freegaussian_tpu_torch.engine.train_step import draw_background

    cpu = torch.device("cpu")
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    bg = draw_background(cfg, cpu, g1, {})
    assert torch.equal(bg, draw_background(cfg, cpu, g2, {}))
    assert bg.shape == (3,) and (bg >= 0).all() and (bg < 1).all()
    injected = torch.tensor([0.25, 0.5, 0.75])
    assert torch.equal(draw_background(cfg, cpu, g1, {"background": injected}), injected)
    black = t_model.SplatConfig(background_color="black")
    assert torch.equal(draw_background(black, cpu, g1, {}), torch.zeros(3))
    np.testing.assert_allclose(t_model.background_color(cfg, cpu).numpy(), [0.1490, 0.1647, 0.2157])


def _optax_state(opt, params, seed):
    """An optax Adam state some steps in, with random moments and count."""
    rng = np.random.default_rng(seed)
    st = opt.init(params)
    adam = st[0]
    moments = lambda scale: jax.tree.map(lambda p: jnp.asarray(rng.normal(scale=scale, size=p.shape), jnp.float32), params)
    nu = jax.tree.map(jnp.abs, moments(1e-4))
    adam = adam._replace(count=jnp.asarray(7, jnp.int32), mu=moments(1e-2), nu=nu)
    rest = tuple(s._replace(count=jnp.asarray(7, jnp.int32)) if "count" in getattr(s, "_fields", ()) else s for s in st[1:])
    return (adam,) + rest


@pytest.mark.parametrize("group", ["means", "opacities", "features_rest", "deform"])
def test_adam_update_matches_optax(group):
    """One update of one group from a state 7 steps in, for a constant-rate
    group and two scheduled ones (means, deform), through the state bridge."""
    from freegaussian_tpu.models.fields import DeformField
    from freegaussian_tpu_torch.models.torch_compat import adam_state_from_optax, deform_state_from_flax

    j_opts = j_opt.make_optimizers(j_opt.OptimizersConfig(max_steps=100))
    t_opts = t_opt.make_optimizers(t_opt.OptimizersConfig(max_steps=100))
    rng = np.random.default_rng(15)
    if group == "deform":
        params = DeformField(depth=2, width=16).init(jax.random.PRNGKey(0), jnp.zeros((1, 3)), jnp.zeros((1, 1)))
        to_port = lambda tree: deform_state_from_flax(jax.tree.map(np.asarray, tree))
    else:
        shape = {"means": (30, 3), "opacities": (30, 1), "features_rest": (30, 45)}[group]
        params = jnp.asarray(rng.normal(size=shape), jnp.float32)
        to_port = lambda arr: {group: torch.tensor(np.asarray(arr))}
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(scale=1e-3, size=p.shape), jnp.float32), params)
    state = _optax_state(j_opts[group], params, 16)
    updates, new_state = jax.jit(j_opts[group].update)(grads, state, params)
    new_params = optax.apply_updates(params, updates)

    t_params = to_port(params)
    t_state = adam_state_from_optax(group, jax.tree.map(np.asarray, state), device="cpu")
    t_opt.adam_update(t_opts[group], t_state, t_params, to_port(grads))
    assert t_state.count == 8
    want_state = adam_state_from_optax(group, jax.tree.map(np.asarray, new_state), device="cpu")
    for k, v in to_port(new_params).items():
        torch.testing.assert_close(t_params[k], v, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(t_state.mu[k], want_state.mu[k], rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(t_state.nu[k], want_state.nu[k], rtol=1e-6, atol=1e-12)


def test_adam_missing_gradient_counts_as_zero():
    opt = t_opt.make_optimizers(t_opt.OptimizersConfig())["scales"]
    p = {"scales": torch.ones(4, 3)}
    st = t_opt.init_adam_state(p)
    t_opt.adam_update(opt, st, p, {"scales": None})
    assert st.count == 1 and torch.equal(p["scales"], torch.ones(4, 3))
