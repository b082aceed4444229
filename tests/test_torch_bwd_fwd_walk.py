"""The compositor's backward by the forward walk (`rasterize_cuda.BWD_WALK =
"fwd"`, kernel `rasterize_bwd_fwd`, the port of the TPU kernel
`rasterize_pallas.py:_bwd_kernel`) against `jax.grad` of
`rasterize_pixels_pallas` with `rasterize_pallas.BWD_WALK = "fwd"`, in
interpret mode, at tile 16 and 32.

On the CPU the port's backward runs its plain version (autograd through the
plain compositor), the same function for both walks; what this holds is the
"fwd" path around it (the saved color and alpha, r_total in plain PyTorch,
the dispatch) and the JAX forward walk's gradients. Budget: the JAX
package's, rtol 1e-3 / atol 1e-4, on a sparse scene; the forward walk's
suffix identity cancels where the suffix is small next to the pixel's total
(deep in a saturated pixel), so a dense scene is not held to it here. The
CUDA kernel is held against the plain version on a GPU by
tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.ops import rasterize_pallas
from freegaussian_tpu.ops.rasterize_pallas import rasterize_pixels_pallas
from freegaussian_tpu_torch.ops import rasterize_cuda
from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_pixels
from test_torch_train_backward import uniform_scene

W, H = 48, 32
RTOL, ATOL = 1e-3, 1e-4


def _jax_grads(scene, target, tile_size):
    def loss(m, c, col, op, sink, depths, radii, tgt):
        render, alpha, _ = rasterize_pixels_pallas(
            m, c, col, op, depths, radii, W, H, tile_size=tile_size, interpret=True, means2d_sink=sink,
        )
        return jnp.sum((render - tgt) ** 2) + 0.3 * jnp.sum(alpha**2)

    m, con, col, op, dep, rad = map(jnp.asarray, scene)
    # traced here, after the knob is set: the walk is chosen at trace time
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(m, con, col, op, jnp.zeros_like(m), dep, rad, jnp.asarray(target))


def _port_grads(scene, target, tile_size):
    m, con, col, op, dep, rad = [torch.tensor(a) for a in scene]
    leaves = [t.requires_grad_(True) for t in (m, con, col, op)]
    sink = torch.zeros_like(m, requires_grad=True)
    render, alpha, _ = rasterize_pixels(*leaves, dep, rad.float(), W, H, tile_size=tile_size, means2d_sink=sink)
    loss = ((render - torch.tensor(target)) ** 2).sum() + 0.3 * (alpha**2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves + [sink])]


@pytest.mark.parametrize("tile_size", [16, 32])
def test_forward_walk_matches_jax_pallas(tile_size, monkeypatch):
    monkeypatch.setattr(rasterize_pallas, "BWD_WALK", "fwd")
    monkeypatch.setattr(rasterize_cuda, "BWD_WALK", "fwd")
    scene = uniform_scene(n=80, seed=2, channels=4)
    target = np.random.default_rng(10).uniform(size=(H, W, 4)).astype(np.float32)
    want = _jax_grads(scene, target, tile_size)
    calls = []
    real = rasterize_cuda.rasterize_tiles_bwd_fwd

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(rasterize_cuda, "rasterize_tiles_bwd_fwd", spy)
    before = dict(rasterize_cuda.LAUNCHES)
    got = _port_grads(scene, target, tile_size)
    assert len(calls) == 1 and rasterize_cuda.LAUNCHES == before  # the "fwd" path, plain on the CPU
    for name, a, b in zip(("means2d", "conics", "colors", "opacities", "absgrad"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(got[4]).max() > 1e-2


def test_forward_walk_r_total_is_the_pixels_total(monkeypatch):
    """The r_total handed to the forward walk is sum_c color g_color + alpha
    g_alpha of the forward's own images, per pixel."""
    monkeypatch.setattr(rasterize_cuda, "BWD_WALK", "fwd")
    scene = uniform_scene(n=60, seed=3, channels=3)
    seen = {}
    real = rasterize_cuda.rasterize_tiles_bwd_fwd

    def spy(*args):
        seen["r_total"], seen["g_color"], seen["g_alpha"] = args[8], args[9], args[10]
        return real(*args)

    monkeypatch.setattr(rasterize_cuda, "rasterize_tiles_bwd_fwd", spy)
    m, con, col, op, dep, rad = [torch.tensor(a) for a in scene]
    col.requires_grad_(True)
    render, alpha, _ = rasterize_pixels(m, con, col, op, dep, rad.float(), W, H, tile_size=16)
    g_color = torch.randn(render.shape, generator=torch.Generator().manual_seed(4))
    torch.autograd.grad((render * g_color).sum() + 2.0 * alpha.sum(), col)
    want = (render.detach() * g_color).sum(-1) + alpha.detach()[..., 0] * 2.0
    torch.testing.assert_close(seen["r_total"], want, rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(rasterize_cuda, "BWD_WALK", "sideways")
    with pytest.raises(ValueError, match="BWD_WALK"):
        rasterize_pixels(m, con, col, op, dep, rad.float(), W, H, tile_size=16)
