"""The port's exports against the JAX package's: the INRIA splat PLY
(`data/splat_export.py`, byte for byte), the orbit camera path
(`data/cameras.py:orbit_camera_path`, within 1e-6) and the reference-format
torch checkpoint, written by one package and loaded by the other for both
`is_blender` values (the deform field with and without its time network):
every tensor arrives equal."""

import numpy as np
import pytest
import torch

from freegaussian_tpu.data.cameras import orbit_camera_path as j_orbit
from freegaussian_tpu.data.splat_export import export_splat_ply as j_export_ply
from freegaussian_tpu.data.splat_export import import_splat_ply as j_import_ply
from freegaussian_tpu.models import torch_compat as j_compat
from freegaussian_tpu_torch.data.cameras import orbit_camera_path
from freegaussian_tpu_torch.data.splat_export import export_splat_ply, import_splat_ply
from freegaussian_tpu_torch.models.gaussians import PARAM_NAMES
from freegaussian_tpu_torch.models.splat_model import SplatConfig, make_control_field, make_deform_field
from freegaussian_tpu_torch.models.torch_compat import (
    export_reference_checkpoint,
    load_control_checkpoint,
    load_reference_checkpoint,
)
from freegaussian_tpu_torch.preprocess.clustering import save_gaussian_mask
from torch_port_helpers import camera_arrays, gaussian_scene_3d, jax_camera, torch_camera


def _scene(sh_degree=3):
    params, alive = gaussian_scene_3d(n=150, seed=1, sh_degree=sh_degree, capacity=200)
    alive = alive & (np.random.default_rng(2).uniform(size=alive.shape) < 0.8)  # dead rows inside the live range
    return params, alive


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("sh_degree", [3, 1])
def test_export_splat_ply_is_the_jax_files_bytes(tmp_path, with_mask, sh_degree):
    params, alive = _scene(sh_degree)
    mask = np.random.default_rng(3).uniform(size=(len(alive), 3)) < 0.3 if with_mask else None
    n = export_splat_ply(tmp_path / "port.ply", {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(alive),
                         None if mask is None else torch.tensor(mask))
    assert n == j_export_ply(tmp_path / "jax.ply", params, alive, mask) == int(alive.sum())
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_import_splat_ply_round_trips_through_both_packages(tmp_path):
    params, alive = _scene()
    export_splat_ply(tmp_path / "a.ply", {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(alive),
                     torch.tensor(np.random.default_rng(4).uniform(size=(len(alive), 2)) < 0.5))
    got, n = import_splat_ply(tmp_path / "a.ply")
    want, jn = j_import_ply(tmp_path / "a.ply")
    assert n == jn == int(alive.sum())
    for name in PARAM_NAMES:
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), params[name][alive])
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def test_orbit_camera_path_matches_jax():
    arrs = [camera_arrays(48, 32, eye=e, time=t) for e, t in (((0.8, 0.5, 4.0), 0.1), ((-1.2, 0.2, 3.6), 0.6))]
    got = orbit_camera_path([torch_camera(a) for a in arrs], num_frames=7)
    want = j_orbit([jax_camera(a) for a in arrs], num_frames=7)
    got_r = orbit_camera_path([torch_camera(a) for a in arrs], num_frames=3, radius=2.5, height=0.4)
    want_r = j_orbit([jax_camera(a) for a in arrs], num_frames=3, radius=2.5, height=0.4)
    for g, w in list(zip(got, want)) + list(zip(got_r, want_r)):
        np.testing.assert_allclose(g.c2w.numpy(), np.asarray(w.c2w), atol=1e-6)
        np.testing.assert_allclose(float(g.time), float(w.time), atol=1e-6)
        np.testing.assert_allclose(g.K.numpy(), np.asarray(w.K), atol=1e-6)
        assert (g.width, g.height) == (w.width, w.height) == (48, 32)
    assert float(got[-1].time) == 1.0


def _fields(is_blender, seed):
    g = torch.Generator().manual_seed(seed)
    cfg = SplatConfig(is_blender=is_blender)
    return cfg, make_deform_field(cfg).reset_parameters(g, 0.1), make_control_field(cfg).reset_parameters(g)


def _assert_state(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("is_blender", [True, False])
def test_port_reference_checkpoint_loads_in_the_jax_package(tmp_path, is_blender):
    params, alive = _scene()
    _, deform, control = _fields(is_blender, seed=5)
    path = export_reference_checkpoint(
        tmp_path / "step.ckpt", {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(alive),
        deform=deform, control=control, step=1234,
    )
    loaded = j_compat.load_reference_checkpoint(path, is_blender=is_blender)
    assert loaded["step"] == 1234
    n = int(alive.sum())
    assert np.asarray(loaded["alive"]).sum() == n
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(loaded["params"][name]), params[name][alive])
    as_torch = lambda vars_, fn, prefix: {k[len(prefix):]: v for k, v in fn(vars_).items()}
    _assert_state(as_torch(loaded["deform_vars"], lambda v: j_compat.deform_vars_to_torch(v, is_blender=is_blender),
                           "deform."), {k: v.numpy() for k, v in deform.state_dict().items()})
    _assert_state(as_torch(loaded["control_vars"], j_compat.control_vars_to_torch, "control."),
                  {k: v.numpy() for k, v in control.state_dict().items()})


@pytest.mark.parametrize("is_blender", [True, False])
def test_jax_reference_checkpoint_loads_in_the_port(tmp_path, is_blender):
    params, alive = _scene()
    cfg, deform, control = _fields(is_blender, seed=6)
    prefixed = lambda field, prefix: {f"{prefix}.{k}": v for k, v in field.state_dict().items()}
    deform_vars = j_compat.deform_vars_from_torch(prefixed(deform, "deform"), is_blender=is_blender)
    control_vars = j_compat.control_vars_from_torch(prefixed(control, "control"))
    path = j_compat.export_reference_checkpoint(
        tmp_path / "step.ckpt", params, alive, deform_vars=deform_vars, control_vars=control_vars, step=77,
        is_blender=is_blender,
    )
    model = load_reference_checkpoint(path, cfg=cfg, device="cpu")
    n = int(alive.sum())
    assert model.step == 77 and int(model.alive.sum()) == n and model.deform.is_blender == is_blender
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(model.params[name].numpy(), params[name][alive])
    _assert_state({k: v.numpy() for k, v in model.deform.state_dict().items()},
                  {k: v.numpy() for k, v in deform.state_dict().items()})

    mask = torch.zeros((len(alive), 2), dtype=torch.bool)
    mask[torch.tensor(alive)] = torch.tensor(np.random.default_rng(7).uniform(size=(n, 2)) < 0.4)
    save_gaussian_mask(tmp_path / f"gaussian_mask_{n}x2.npy", mask, torch.tensor(alive))
    model2 = load_control_checkpoint(path, tmp_path / f"gaussian_mask_{n}x2.npy", cfg=cfg, device="cpu")
    _assert_state({k: v.numpy() for k, v in model2.control.state_dict().items()},
                  {k: v.numpy() for k, v in control.state_dict().items()})
    np.testing.assert_array_equal(model2.gaussian_mask[:n].numpy(), mask[torch.tensor(alive)].numpy())
