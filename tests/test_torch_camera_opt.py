"""The port's camera-pose optimizer (SO3xR3) against the JAX package's:
`skew`, `exp_so3`, `apply_camera_opt` and `camera_opt_reg_loss`, forward and
gradient (`jax.grad` against autograd) on the same seeded numpy inputs,
including the zero tangent (axis = 0 / safe_norm's eps), to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models import camera_opt as j_cam
from freegaussian_tpu.ops import math as j_math
from freegaussian_tpu_torch.models import camera_opt as t_cam
from freegaussian_tpu_torch.ops import math as t_math
from torch_port_helpers import camera_arrays, jax_camera, torch_camera

TOL = dict(rtol=1e-6, atol=1e-6)


def _adjustments(seed=0, n=5):
    """(n, 6) seeded tangents; row 2 is the zero tangent."""
    adj = np.random.default_rng(seed).normal(scale=0.2, size=(n, 6)).astype(np.float32)
    adj[2] = 0.0
    return adj


def test_skew_and_exp_so3_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(7, 3)).astype(np.float32)
    theta = np.linalg.norm(w, axis=-1, keepdims=True).astype(np.float32)
    axis = (w / theta).astype(np.float32)
    np.testing.assert_array_equal(t_math.skew(torch.tensor(w)).numpy(), np.asarray(j_math.skew(jnp.asarray(w))))
    got = t_math.exp_so3(torch.tensor(axis), torch.tensor(theta)).numpy()
    want = np.asarray(j_math.exp_so3(jnp.asarray(axis), jnp.asarray(theta)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape), atol=1e-5)


@pytest.mark.parametrize("cam_idx", [0, 2, 4])  # 2: the zero tangent
def test_apply_camera_opt_matches_jax(cam_idx):
    adj = _adjustments()
    arrs = camera_arrays()
    weights = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)

    def j_loss(a):
        return jnp.sum(j_cam.apply_camera_opt(a, jax_camera(arrs), cam_idx).c2w * weights)

    want_c2w = np.asarray(j_cam.apply_camera_opt(jnp.asarray(adj), jax_camera(arrs), cam_idx).c2w)
    want_grad = np.asarray(jax.grad(j_loss)(jnp.asarray(adj)))

    a = torch.tensor(adj, requires_grad=True)
    cam = t_cam.apply_camera_opt(a, torch_camera(arrs), cam_idx)
    torch.sum(cam.c2w * torch.tensor(weights)).backward()
    np.testing.assert_allclose(cam.c2w.detach().numpy(), want_c2w, **TOL)
    np.testing.assert_allclose(a.grad.numpy(), want_grad, **TOL)
    assert np.isfinite(a.grad.numpy()).all()
    if cam_idx == 2:
        # the identity adjustment, and the rotation's derivative there is finite and nonzero
        np.testing.assert_array_equal(cam.c2w.detach().numpy(), arrs["c2w"])
        assert np.abs(a.grad.numpy()[2, :3]).max() > 0
    assert cam.width == arrs["width"] and torch.equal(cam.fx, torch_camera(arrs).fx)


def test_camera_opt_reg_loss_and_init_match_jax():
    adj = _adjustments(seed=4)
    want = float(j_cam.camera_opt_reg_loss(jnp.asarray(adj)))
    want_grad = np.asarray(jax.grad(lambda a: j_cam.camera_opt_reg_loss(a))(jnp.asarray(adj)))
    a = torch.tensor(adj, requires_grad=True)
    got = t_cam.camera_opt_reg_loss(a)
    got.backward()
    np.testing.assert_allclose(float(got), want, **TOL)
    np.testing.assert_allclose(a.grad.numpy(), want_grad, **TOL)
    np.testing.assert_array_equal(t_cam.init_camera_opt(4, device="cpu").numpy(), np.asarray(j_cam.init_camera_opt(4)))
