"""The compositor backward's quadrant design, on the CPU: the plain PyTorch
model of what the CUDA kernels compute (`rasterize_tiles_bwd_quadrants_plain`:
per-quadrant partial sums of each slot's terms, then the fixed-order combine
with the opacity division and the abs after the whole kernel tile's sum).

At tile 32 it is held to `rasterize_tiles_bwd_plain` (autograd through the
plain compositor with the whole frame's cotangents) to 1e-6 of the largest
element, and, reduced per Gaussian, to `jax.grad` of the JAX package's
Pallas compositor (the reverse-walk backward in interpret mode) at the JAX
package's budget (tests/test_rasterize_pallas.py: rtol 1e-3 / atol 1e-4;
2e-3 / 2e-4 at dense termination), absgrad included. At tile 16 it is the
one-quadrant case: its one partial is the whole row. The CUDA kernels are held
against the plain backward on a GPU by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu_torch.ops.rasterize_cuda import (
    combine_quadrants_plain,
    quadrant_partials_plain,
    quadrants,
    rasterize_tiles_bwd_plain,
    rasterize_tiles_bwd_quadrants_plain,
    rasterize_tiles_plain,
    reduce_rows_by_gid,
)
from freegaussian_tpu_torch.ops.tiles import build_intersections
from test_torch_train_backward import _jax_grads_fn, uniform_scene
from torch_port_helpers import clustered_scene_2d


def _case(scene, width, height, tile_size, seed):
    m, con, col, op, dep, rad = [torch.tensor(a) for a in scene]
    r = rad.float()
    isect = build_intersections(m, r, dep, width, height, tile_size)
    g = torch.Generator().manual_seed(seed)
    g_color = torch.randn(height, width, col.shape[1], generator=g)
    g_alpha = torch.randn(height, width, generator=g)
    args = (m, con, col, op, r, isect.gauss_ids, isect.tile_offsets, g_color, g_alpha, width, height, tile_size)
    return args, isect


def _close_to_max(got, want, rel=1e-6):
    scale = float(want.abs().max())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= rel * max(scale, 1e-30), float((got - want).abs().max()) / scale


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("channels", [3, 5])
def test_quadrant_model_matches_plain_backward_at_tile_32(channels, dense):
    # 100 x 70: ragged tiles, quadrants with no pixel inside the frame
    scene = clustered_scene_2d(n=300, width=100, height=70, seed=channels + 3, channels=channels, dense=dense)
    args, isect = _case(scene, 100, 70, 32, channels)
    partials = quadrant_partials_plain(*args)
    assert partials.shape == (4, isect.num_isects, 6 + channels)
    # a quadrant of the right column reaches only x >= 112: no pixel there
    assert torch.equal(partials[1][_slots_of_tile(isect, 3)], torch.zeros_like(partials[1][_slots_of_tile(isect, 3)]))
    got = combine_quadrants_plain(partials, args[3], args[5])
    want = rasterize_tiles_bwd_plain(*args)
    _close_to_max(got, want)
    # slots whose contract bbox covers 1, 2 and 4 quadrants of their tile
    covered = (partials.abs().sum(-1) > 0).sum(0)
    assert {1, 2, 4} <= set(covered.tolist())
    # absgrad: the abs of the whole tile's sum, not the sum of the quadrants' abs
    assert torch.equal(got[:, 6:8], got[:, 0:2].abs())
    assert (partials[..., :2].abs().sum(0) > got[:, 6:8] + 1e-6).any()


def _slots_of_tile(isect, tile):
    offs = isect.tile_offsets.long()
    return torch.arange(int(offs[tile]), int(offs[tile + 1]))


@pytest.mark.parametrize("channels", [3, 4])
def test_quadrant_model_is_the_identity_at_tile_16(channels):
    scene = clustered_scene_2d(n=200, width=64, height=40, seed=channels, channels=channels)
    args, isect = _case(scene, 64, 40, 16, channels + 1)
    partials = quadrant_partials_plain(*args)
    assert quadrants(16) == 1 and partials.shape == (1, isect.num_isects, 6 + channels)
    want = rasterize_tiles_bwd_plain(*args)
    _close_to_max(rasterize_tiles_bwd_quadrants_plain(*args), want)
    # the one partial holds the row's own terms: d means2d, d conic, d colors
    torch.testing.assert_close(partials[0][:, :5], want[:, :5], rtol=0, atol=0)
    torch.testing.assert_close(partials[0][:, 6:], want[:, 8:], rtol=0, atol=0)


def _jax_loss_cotangents(color, alpha, target, dense):
    """d loss / d (color, alpha) of the loss of `_jax_grads_fn`."""
    if dense:
        return torch.sign(color - target), torch.ones_like(alpha)
    return 2.0 * (color - target), 0.6 * alpha


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("channels", [3, 5])
def test_quadrant_model_matches_jax_pallas(channels, dense):
    if dense:
        # heavy overlap at opacity up to 0.999: most pixels terminate
        scene, (w, h) = uniform_scene(n=200, width=32, height=32, seed=7, opac_scale=0.999, channels=channels), (32, 32)
        rtol, atol = 2e-3, 2e-4
    else:
        scene, (w, h) = uniform_scene(n=80, seed=1, channels=channels), (48, 32)
        rtol, atol = 1e-3, 1e-4
    target = np.random.default_rng(9).uniform(size=(h, w, channels)).astype(np.float32)
    want = _jax_grads_fn(w, h, 32, dense)(*map(jnp.asarray, scene[:4]), jnp.zeros_like(jnp.asarray(scene[0])),
                                           *map(jnp.asarray, scene[4:]), jnp.asarray(target))
    m, con, col, op, dep, rad = [torch.tensor(a) for a in scene]
    r = rad.float()
    isect = build_intersections(m, r, dep, w, h, 32)
    fwd = (m, con, col, op, r, isect.gauss_ids, isect.tile_offsets)
    color, alpha, _, _ = rasterize_tiles_plain(*fwd, w, h, 32)
    g_color, g_alpha = _jax_loss_cotangents(color, alpha, torch.tensor(target), dense)
    rows = rasterize_tiles_bwd_quadrants_plain(*fwd, g_color, g_alpha, w, h, 32)
    g = reduce_rows_by_gid(rows, isect.gauss_ids, isect.offsets, isect.counts).numpy()
    got = (g[:, 0:2], g[:, 2:5], g[:, 8:], g[:, 5], g[:, 6:8])
    for name, a, b in zip(("means2d", "conics", "colors", "opacities", "absgrad"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=name)
    assert np.abs(got[4]).max() > 1e-2
