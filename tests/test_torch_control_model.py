"""The port's stage-2 control model (`models/control_model.py`, the mask file
I/O, the stage-2 checkpoints, the slider viewer) against the JAX package on
the same seeded inputs, on the CPU.

The control field runs its f32 split-linear chain on both sides (the
port's `deform_impl="headsfused"`; the JAX package's flax path, its only
path off the TPU), the deform field an f32 depth-2 width-32 chain, and the
JAX forward the Pallas compositor in interpret mode. Tolerances: the
control state rtol 1e-4 / atol 1e-6 (f32 summation order through the deform
field and the cluster means); rgb and accumulation atol 2e-5 (the JAX
package's forward budget), depth rtol 1e-4 where accumulation > 0.05.
"""

import functools
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models import torch_compat as j_compat
from freegaussian_tpu.models.control_model import blend_control_values as j_blend
from freegaussian_tpu.models.control_model import control_forward as j_control_forward
from freegaussian_tpu.models.control_model import control_state_from_deform as j_control_state
from freegaussian_tpu.models.fields import ControlField as JControlField
from freegaussian_tpu.models.fields import DeformField as JDeformField
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu.preprocess.clustering import save_gaussian_mask as j_save_mask
from freegaussian_tpu_torch import cli
from freegaussian_tpu_torch.engine.checkpoints import cross_load_stage1
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
from freegaussian_tpu_torch.engine.train_step import create_train_state
from freegaussian_tpu_torch.models import torch_compat as t_compat
from freegaussian_tpu_torch.models.control_model import (
    Controller,
    ControlModel,
    blend_control_values,
    control_forward,
    control_state_from_deform,
)
from freegaussian_tpu_torch.models.fields import ControlField, DeformField
from freegaussian_tpu_torch.models.splat_model import SplatConfig as TConfig
from freegaussian_tpu_torch.preprocess.clustering import load_gaussian_mask, save_gaussian_mask
from freegaussian_tpu_torch.viewer.server import ViewerServer, control_render_fn, encode_jpeg, orbit_camera, to_rgb8
from torch_port_helpers import camera_arrays, field_shapes, flax_linear_vars, gaussian_scene_3d, jax_camera, torch_camera

ATOL = 2e-5
W, H = 96, 64
M = 3
J_DEFORM = JDeformField(depth=2, width=32)


def stage2_scene(seed=0, n=200, capacity=216):
    """Padded Gaussians with a few dead rows, an (N, 3) cluster mask, f32
    depth-2 deform variables and ControlField variables (heads x 0.1)."""
    params, alive = gaussian_scene_3d(n=n, seed=seed, capacity=capacity)
    alive = alive.copy()
    alive[5:9] = False
    rng = np.random.default_rng(seed + 100)
    mask = rng.uniform(size=(capacity, M)) < 0.35
    mask[:3] = False  # in no cluster
    dvars = flax_linear_vars(rng, field_shapes("deform", depth=2, width=32), [1.0] * 4 + [0.3] * 4)
    cvars = flax_linear_vars(rng, field_shapes("control"), [1.0] * 8 + [0.1] * 3)
    return params, alive, mask, dvars, cvars


def port_fields(dvars, cvars, cfg=TConfig(deform_impl="headsfused")):
    deform = DeformField(depth=2, width=32)
    deform.load_state_dict(t_compat.deform_state_from_flax(dvars), strict=True)
    control = t_compat.make_control_field(cfg)
    control.load_state_dict(t_compat.control_state_from_flax(cvars), strict=True)
    return deform, control


def arrs(time=0.6):
    return camera_arrays(width=W, height=H, focal=80.0, time=time)


def test_control_state_and_blend_match_jax():
    params, alive, mask, dvars, _ = stage2_scene(seed=1)
    deform, _ = port_fields(dvars, flax_linear_vars(np.random.default_rng(0), field_shapes("control")))
    means = params["means"]
    j_state = jax.jit(functools.partial(j_control_state, J_DEFORM.apply))
    want = j_state(dvars, jnp.asarray(means), jnp.asarray(mask), jnp.asarray(0.1), jnp.asarray(0.7), alive=jnp.asarray(alive))
    got = control_state_from_deform(deform, torch.tensor(means), torch.tensor(mask), 0.1, torch.tensor(0.7),
                                    alive=torch.tensor(alive))
    assert got.shape == (M, 3) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    assert float(got.abs().max()) > 1e-3  # the field moves the clusters
    same = control_state_from_deform(deform, torch.tensor(means), torch.tensor(mask), 0.4, 0.4)
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-7)

    d_avg = np.random.default_rng(2).normal(size=(M, 3)).astype(np.float32)
    np.testing.assert_allclose(
        blend_control_values(torch.tensor(mask), torch.tensor(d_avg)).numpy(),
        np.asarray(j_blend(jnp.asarray(mask), jnp.asarray(d_avg))), rtol=1e-6, atol=1e-7,
    )


@functools.partial(jax.jit, static_argnames=("train",))
def _j_forward(params, alive, mask, camera, cvars, dvars, atrb, train):
    out = j_control_forward(
        JConfig(backend="pallas"), params, alive, mask, camera, JControlField().apply, cvars,
        deform_apply=J_DEFORM.apply, deform_vars=dvars, init_time=jnp.asarray(0.2),
        atrb_values=atrb, sh_degree_now=3, train=train,
    )
    return {k: out[k] for k in ("rgb", "accumulation", "control_state", "radii") + (() if train else ("depth",))}


def _compare(out, want, train):
    np.testing.assert_allclose(out["control_state"].detach().numpy(), want["control_state"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out["rgb"].detach().numpy(), want["rgb"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["accumulation"].detach().numpy(), want["accumulation"], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out["radii"].numpy(), want["radii"])
    if not train:
        seen = want["accumulation"] > 0.05
        np.testing.assert_allclose(out["depth"].numpy()[seen], want["depth"][seen], rtol=1e-4, atol=ATOL)
    assert want["accumulation"].max() > 0.9


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_control_forward_matches_jax(mode):
    """Eval: injected attribute values (the slider path); train: the control
    state from the deform field between init_time 0.2 and the frame's time,
    and the control field's gradient reaching the means."""
    params, alive, mask, dvars, cvars = stage2_scene(seed=2)
    train = mode == "train"
    atrb = np.asarray([[0.3, -0.2, 0.1], [0.0, 0.25, -0.3], [-0.1, 0.0, 0.2]], np.float32)
    J = lambda a: jnp.asarray(a)
    want = _j_forward({k: J(v) for k, v in params.items()}, J(alive), J(mask), jax_camera(arrs()), cvars, dvars,
                      None if train else J(atrb), train)
    want = {k: np.asarray(v) for k, v in want.items()}
    deform, control = port_fields(dvars, cvars)
    tparams = {k: torch.tensor(v, requires_grad=train) for k, v in params.items()}
    out = control_forward(
        TConfig(), tparams, torch.tensor(alive), torch.tensor(mask), torch_camera(arrs()), control,
        deform=deform, init_time=0.2, atrb_values=None if train else atrb, sh_degree_now=3, train=train,
    )
    _compare(out, want, train)
    if train:
        out["rgb"].sum().backward()
        assert float(tparams["means"].grad.abs().max()) > 0
        assert all(p.grad is not None for p in control.parameters())
        assert all(p.grad is None for p in deform.parameters())  # the deform field only sets the state
    else:
        assert not out["rgb"].requires_grad
        np.testing.assert_array_equal(out["control_state"].numpy(), atrb)


def _write_stage2(tmp_path, params, alive, mask, cvars, step=45000):
    """The JAX package writes a stage-2 reference checkpoint (a full 8x256
    deform field, the control field) and the mask file."""
    J = lambda a: jnp.asarray(a)
    dvars8 = flax_linear_vars(np.random.default_rng(77), field_shapes("deform"))
    path = j_compat.export_reference_checkpoint(
        tmp_path / f"step-{step:09d}.ckpt", {k: J(v) for k, v in params.items()}, J(alive),
        deform_vars=dvars8, control_vars=cvars if step else None, step=step,
    )
    mask_path = tmp_path / f"gaussian_mask_{int(alive.sum())}x{M}.npy"
    j_save_mask(mask_path, J(mask), J(alive))
    return path, mask_path, dvars8


def test_stage2_checkpoint_round_trip_matches_jax(tmp_path):
    """Mask -> a reference checkpoint with control.* keys and the mask file
    -> `load_control_checkpoint` -> the slider render, against the JAX
    package's render of the same state. The loaded model holds the live
    Gaussians first, so the JAX side renders the compacted arrays."""
    params, alive, mask, dvars, cvars = stage2_scene(seed=3)
    path, mask_path, dvars8 = _write_stage2(tmp_path, params, alive, mask, cvars)
    want_control = t_compat.control_state_from_flax(cvars)
    want_deform = t_compat.deform_state_from_flax(dvars8)

    cap = len(alive) + 8
    model = t_compat.load_control_checkpoint(path, mask_path, capacity=cap, cfg=TConfig(deform_impl="headsfused"), device="cpu")
    assert isinstance(model, ControlModel) and model.step == 45000 and model.num_attributes == M
    n = int(alive.sum())
    assert int(model.alive.sum()) == n and bool(model.alive[:n].all())
    np.testing.assert_array_equal(model.gaussian_mask[:n].numpy(), mask[alive])
    assert not model.gaussian_mask[n:].any()
    for k, v in want_control.items():
        assert torch.equal(model.control.state_dict()[k], v), k
    for k, v in want_deform.items():
        assert torch.equal(model.deform.state_dict()[k], v), k
    live = {k: np.pad(v[alive], [(0, cap - n)] + [(0, 0)] * (v.ndim - 1)) for k, v in params.items()}
    np.testing.assert_array_equal(model.params["means"].numpy(), live["means"])

    atrb = np.asarray([[0.5, 0.1, -0.2], [0.0, -0.3, 0.3], [0.2, 0.2, 0.0]], np.float32)
    out = model(torch_camera(arrs()), atrb)
    J = lambda a: jnp.asarray(a)
    live_mask = np.zeros((cap, M), bool)
    live_mask[:n] = mask[alive]
    want = _j_forward({k: J(v) for k, v in live.items()}, J(np.arange(cap) < n), J(live_mask), jax_camera(arrs()),
                      cvars, dvars, J(atrb), False)
    _compare(out, {k: np.asarray(v) for k, v in want.items()}, False)


def test_cross_load_stage1(tmp_path):
    """A stage-1 reference checkpoint starts stage 2
    (`engine/checkpoints.py:cross_load_stage1`): Gaussians, alive and deform
    from the checkpoint, its live rows first; the control field and the Adam
    states keep their fresh initialization; serving that checkpoint as a
    stage-2 model is refused."""
    params, alive, mask, _, cvars = stage2_scene(seed=4, n=60, capacity=64)
    path, mask_path, dvars8 = _write_stage2(tmp_path, params, alive, mask, cvars, step=0)
    cap, n = len(alive), int(alive.sum())
    control = ControlField().reset_parameters(torch.Generator().manual_seed(9))
    fresh = {k: v.clone() for k, v in control.state_dict().items()}
    state = create_train_state(
        {k: torch.zeros(v.shape) for k, v in params.items()}, torch.zeros(cap, dtype=torch.bool),
        DeformField(), make_optimizers(OptimizersConfig()), generator=torch.Generator(), control=control,
    )
    cross_load_stage1(path, state)
    assert int(state.alive.sum()) == n and bool(state.alive[:n].all())
    for k, v in params.items():
        np.testing.assert_array_equal(state.params[k][:n].detach().numpy(), v[alive])
        assert not state.params[k][n:].any(), k
    np.testing.assert_array_equal(load_gaussian_mask(mask_path, cap, state.alive)[:n].numpy(), mask[alive])
    for k, v in t_compat.deform_state_from_flax(dvars8).items():
        assert torch.equal(state.deform.state_dict()[k], v), k
    for k, v in fresh.items():
        assert torch.equal(state.control.state_dict()[k], v), k
    assert not any(mu.any() for s in state.opt_states.values() for mu in s.mu.values())
    with pytest.raises(KeyError, match="control"):
        t_compat.load_control_checkpoint(path, mask_path, cfg=TConfig(deform_impl="headsfused"), device="cpu")


def test_mask_file_round_trip_with_dead_rows(tmp_path):
    rng = np.random.default_rng(6)
    alive = torch.tensor(rng.uniform(size=50) < 0.7)
    mask = torch.tensor(rng.uniform(size=(50, 4)) < 0.4)
    path = tmp_path / "gaussian_mask.npy"
    save_gaussian_mask(path, mask, alive)
    assert np.load(path).shape == (int(alive.sum()), 4)
    back = load_gaussian_mask(path, 50, alive)
    assert back.dtype == torch.bool and torch.equal(back[alive], mask[alive]) and not back[~alive].any()
    # the JAX package reads the port's file into the same rows
    from freegaussian_tpu.preprocess.clustering import load_gaussian_mask as j_load_mask

    np.testing.assert_array_equal(np.asarray(j_load_mask(path, 50, jnp.asarray(alive.numpy()))), back.numpy())


def test_controller_scales_the_sliders():
    c = Controller(3)
    c.set_vector3(1, [1.0, 2.0, 3.0])
    np.testing.assert_allclose(c.get_atrb_vals()[1], [0.1, 0.2, 0.3], atol=1e-7)
    np.testing.assert_allclose(c.get_atrb_vals()[0], 0.0)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_cli_viewer_serves_stage2_sliders(tmp_path):
    """`viewer --gaussian-mask`: /info reports the mask's attributes, and a
    request's `atrb` (x0.1, as the sliders scale) drives the control field."""
    params, alive, mask, _, cvars = stage2_scene(seed=5)
    path, mask_path, _ = _write_stage2(tmp_path, params, alive, mask, cvars)
    args = cli.build_parser().parse_args(
        ["viewer", "--checkpoint", str(path), "--gaussian-mask", str(mask_path), "--deform-impl", "pallas"]
    )
    assert args.deform_impl == "pallas" and args.gaussian_mask == str(mask_path)
    model, server = cli.start_viewer(
        path, port=0, width=W, height=H, device="cpu", host="127.0.0.1", gaussian_mask=mask_path,
        deform_impl="headsfused",
    )
    try:
        assert isinstance(model, ControlModel) and model.control.impl == "split"
        status, _, body = _get(server.port, "/info")
        assert status == 200 and json.loads(body) == {"num_attributes": M}
        sliders = [3.0, -2.0, 1.0, 0.0, 2.5, -3.0, -1.0, 0.0, 2.0]
        status, ctype, body = _get(server.port, "/render?th=0.2&ph=0.1&r=4&t=0.5&atrb=" + ",".join(map(str, sliders)))
        assert status == 200 and ctype == "image/jpeg"
        cam = orbit_camera(0.2, 0.1, 4.0, width=W, height=H, time=0.5, device="cpu")
        want = model(cam, 0.1 * np.asarray(sliders, np.float32).reshape(M, 3))["rgb"]
        assert body == encode_jpeg(to_rgb8(want))
        rest = _get(server.port, "/render?th=0.2&ph=0.1&r=4&t=0.5")[2]
        assert rest == encode_jpeg(to_rgb8(control_render_fn(model)(cam)))
        assert rest != body  # the sliders move the render
    finally:
        server.shutdown()
    pallas = t_compat.load_control_checkpoint(path, mask_path, cfg=TConfig(deform_impl="pallas"), device="cpu")
    assert pallas.control.impl == "pallas" and pallas.deform.impl == "pallas"
