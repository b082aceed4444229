"""The port's deform field, SE(3) warp, Gaussian layout and checkpoint IO vs
the JAX package, with weights handed over by the weight bridge
(`state_from_jax_arrays`) from a flax init.

Tolerances: f32 mode atol 1e-5 (the same f32 math in another summation
order). bf16 mode atol 1e-3 on outputs of order 0.1-1, a bf16-class bound:
both sides round at the same points (each split-linear partial product,
their sum, the bias), but the f32 accumulation order inside a product may
still flip one bf16 rounding (2^-8 relative) of a trunk activation, which
the normalization w / theta amplifies (max 3.5e-7 seen on this scene)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models import torch_compat as j_compat
from freegaussian_tpu.models.fields import SE3Screw as JScrew
from freegaussian_tpu.models.fields import deform_apply_headsfused
from freegaussian_tpu.models.gaussians import colors_from_features as j_colors
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu.models.splat_model import make_deform_field
from freegaussian_tpu_torch.models import torch_compat as t_compat
from freegaussian_tpu_torch.models.fields import SE3Screw as TScrew
from freegaussian_tpu_torch.models.gaussians import colors_from_features as t_colors
from freegaussian_tpu_torch.models.splat_model import SplatConfig as TConfig
from torch_port_helpers import gaussian_scene_3d


def _flax_deform(bf16, is_blender=True, seed=1):
    cfg = JConfig(deform_bf16=bf16, is_blender=is_blender)
    field = make_deform_field(cfg)
    dvars = field.init(jax.random.PRNGKey(seed), jnp.zeros((1, 3)), jnp.zeros((1, 1)))
    return field, dvars


def _port_model(params, alive, dvars, bf16, is_blender=True):
    # the split-linear chain: the twin of the flax path the JAX side runs here
    cfg = TConfig(deform_bf16=bf16, is_blender=is_blender, deform_impl="headsfused")
    return t_compat.state_from_jax_arrays(
        params, alive, jax.tree.map(np.asarray, dvars), cfg=cfg, device="cpu"
    )


def _compare_deform(field, dvars, deform, x, t, atol):
    jd, jr, js = deform_apply_headsfused(field, dvars, jnp.asarray(x), jnp.asarray(t))
    td, tr, ts = deform(torch.tensor(x), torch.tensor(t))
    for name, a, b in (
        ("w", jd.w, td.w), ("v", jd.v, td.v), ("theta", jd.theta, td.theta),
        ("rotation", jr, tr), ("scaling", js, ts),
        ("warped means", jd.apply(jnp.asarray(x)), td.apply(torch.tensor(x))),
    ):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("is_blender", [True, False], ids=["blender", "no-timenet"])
@pytest.mark.parametrize("per_point_time", [False, True], ids=["shared-t", "per-point-t"])
def test_deform_field_f32_matches_jax(is_blender, per_point_time):
    params, alive = gaussian_scene_3d(n=96, seed=3)
    field, dvars = _flax_deform(False, is_blender)
    model = _port_model(params, alive, dvars, False, is_blender)
    x = params["means"]
    rng = np.random.default_rng(4)
    t = rng.uniform(size=(96, 1) if per_point_time else (1, 1)).astype(np.float32)
    _compare_deform(field, dvars, model.deform, x, t, atol=1e-5)


def test_deform_field_bf16_matches_jax():
    params, alive = gaussian_scene_3d(n=128, seed=5)
    field, dvars = _flax_deform(True)
    model = _port_model(params, alive, dvars, True)
    assert model.deform.compute_dtype == torch.bfloat16
    _compare_deform(field, dvars, model.deform, params["means"], np.full((1, 1), 0.7, np.float32), atol=1e-3)


def test_se3_screw_apply_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    theta = rng.uniform(0, 2, size=(64, 1)).astype(np.float32)
    m = rng.normal(size=(64, 3)).astype(np.float32)
    a = JScrew(*map(jnp.asarray, (w, v, theta))).apply(jnp.asarray(m))
    b = TScrew(*map(torch.tensor, (w, v, theta))).apply(torch.tensor(m))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    # and against the 4x4 matrix form
    mat = np.asarray(JScrew(*map(jnp.asarray, (w, v, theta))).matrix())
    homog = np.concatenate([m, np.ones((64, 1), np.float32)], axis=-1)
    np.testing.assert_allclose(b.numpy(), np.einsum("nij,nj->ni", mat, homog)[:, :3], atol=1e-5)


def test_colors_from_features_matches_jax():
    params, _ = gaussian_scene_3d(n=40, seed=7)
    j = j_colors({k: jnp.asarray(v) for k, v in params.items()})
    t = t_colors({k: torch.tensor(v) for k, v in params.items()})
    assert t.shape == (40, 16, 3)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_weight_bridge_keeps_padded_layout():
    params, alive = gaussian_scene_3d(n=50, seed=8, capacity=64)
    _, dvars = _flax_deform(False)
    model = _port_model(params, alive, dvars, False)
    assert model.alive.tolist() == alive.tolist()
    for name, arr in params.items():
        np.testing.assert_array_equal(model.params[name].numpy(), arr)
    k = np.asarray(dvars["params"]["TorchLinear_2"]["kernel"])
    np.testing.assert_array_equal(model.deform.linear[0].weight.detach().numpy(), k.T)


def test_checkpoint_round_trip_from_jax(tmp_path):
    """JAX export_reference_checkpoint -> port load_reference_checkpoint:
    the live Gaussians and the deform outputs come through unchanged."""
    params, alive = gaussian_scene_3d(n=70, seed=9, capacity=80)
    field, dvars = _flax_deform(False)
    path = j_compat.export_reference_checkpoint(
        tmp_path / "step-000030000.ckpt", {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(alive), deform_vars=dvars, step=30000,
    )
    model = t_compat.load_reference_checkpoint(path, capacity=96, cfg=TConfig(deform_bf16=False), device="cpu")
    assert model.step == 30000 and int(model.alive.sum()) == 70 and model.alive.shape == (96,)
    for name, arr in params.items():
        np.testing.assert_array_equal(model.params[name][:70].numpy(), arr[:70])
        assert torch.all(model.params[name][70:] == 0)
    x = params["means"][:70]
    _compare_deform(field, dvars, model.deform, x, np.full((1, 1), 0.25, np.float32), atol=1e-5)


def test_checkpoint_round_trip_port_to_jax_and_ddp_prefixes(tmp_path):
    """Port export -> JAX load gives the same arrays, and DDP-prefixed keys
    load into the port."""
    params, alive = gaussian_scene_3d(n=30, seed=10)
    _, dvars = _flax_deform(False)
    model = _port_model(params, alive, dvars, False)
    path = t_compat.export_reference_checkpoint(
        tmp_path / "a.ckpt", model.params, model.alive, deform=model.deform, step=7
    )
    loaded = j_compat.load_reference_checkpoint(path)
    assert loaded["step"] == 7
    for name, arr in params.items():
        np.testing.assert_array_equal(np.asarray(loaded["params"][name]), arr)
    for layer, p in dvars["params"].items():
        np.testing.assert_array_equal(np.asarray(loaded["deform_vars"]["params"][layer]["kernel"]), np.asarray(p["kernel"]))

    state = torch.load(path, weights_only=True)
    ddp = {"pipeline": {"module." + k.replace("_model.", "_model.module."): v for k, v in state["pipeline"].items()}, "step": 7}
    torch.save(ddp, tmp_path / "ddp.ckpt")
    again = t_compat.load_reference_checkpoint(tmp_path / "ddp.ckpt", cfg=TConfig(deform_bf16=False), device="cpu")
    for (ka, va), (kb, vb) in zip(model.state_dict().items(), again.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
