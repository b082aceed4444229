"""The port's bilateral grid against the JAX package's: `init_bilateral_grids`,
`slice_bilateral_grid` and `total_variation_loss`, forward and gradient
(`jax.grad` against autograd, in the grids and in the image) on the same
seeded numpy inputs, to 1e-6. The image holds pixels whose guide is exactly
0 (black) and exactly 1 (white), and pixels outside [0, 1] (the clipped
guide), so the grid's clamped edges on the guide axis are sliced; an odd
frame size puts pixel centres near the grid's x and y edges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models import bilagrid as j_bg
from freegaussian_tpu_torch.models import bilagrid as t_bg

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(h, w, seed=0, n_images=3):
    rng = np.random.default_rng(seed)
    grids = np.asarray(j_bg.init_bilateral_grids(n_images)) + rng.normal(scale=0.1, size=(n_images, 8, 16, 16, 12))
    rgb = rng.uniform(-0.2, 1.2, size=(h, w, 3))
    rgb[0, :5] = 0.0  # guide exactly 0
    rgb[1, :5] = 1.0  # guide exactly 1 (0.299 + 0.587 + 0.114 == 1 in f32)
    weights = rng.normal(size=(h, w, 3))
    f = lambda a: a.astype(np.float32)
    return f(grids), f(rgb), f(weights)


def test_init_matches_jax():
    np.testing.assert_array_equal(
        t_bg.init_bilateral_grids(2, device="cpu").numpy(), np.asarray(j_bg.init_bilateral_grids(2))
    )


@pytest.mark.parametrize("hw,idx", [((24, 32), 1), ((19, 37), 2)])
def test_slice_matches_jax_forward_and_gradient(hw, idx):
    grids, rgb, weights = _inputs(*hw)

    def j_loss(g, x):
        return jnp.sum(j_bg.slice_bilateral_grid(g, idx, x) * weights)

    want = np.asarray(j_bg.slice_bilateral_grid(jnp.asarray(grids), idx, jnp.asarray(rgb)))
    want_gg, want_gx = (np.asarray(a) for a in jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(grids), jnp.asarray(rgb)))

    g = torch.tensor(grids, requires_grad=True)
    x = torch.tensor(rgb, requires_grad=True)
    out = t_bg.slice_bilateral_grid(g, idx, x)
    torch.sum(out * torch.tensor(weights)).backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(g.grad.numpy(), want_gg, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_gx, **TOL)
    assert not g.grad[[i for i in range(grids.shape[0]) if i != idx]].any()  # other images' grids untouched


def test_identity_grid_is_a_no_op():
    x = torch.rand(12, 20, 3, generator=torch.Generator().manual_seed(0))
    out = t_bg.slice_bilateral_grid(t_bg.init_bilateral_grids(1, device="cpu"), 0, x)
    torch.testing.assert_close(out, x, rtol=0, atol=1e-6)


def test_total_variation_matches_jax():
    grids, _, _ = _inputs(4, 4, seed=5)
    want = float(j_bg.total_variation_loss(jnp.asarray(grids)))
    want_grad = np.asarray(jax.grad(j_bg.total_variation_loss)(jnp.asarray(grids)))
    g = torch.tensor(grids, requires_grad=True)
    tv = t_bg.total_variation_loss(g)
    tv.backward()
    np.testing.assert_allclose(float(tv), want, **TOL)
    np.testing.assert_allclose(g.grad.numpy(), want_grad, **TOL)
    assert float(t_bg.total_variation_loss(t_bg.init_bilateral_grids(2, device="cpu"))) == 0.0
