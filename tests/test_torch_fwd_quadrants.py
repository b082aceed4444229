"""The compositor forward's quadrant design, on the CPU: the plain PyTorch
model of what the CUDA kernel computes (`rasterize_tiles_quadrants_plain`:
per 16 x 16 quadrant of a tile, the run's slots whose contract bbox holds the
quadrant, compacted in run order with their ranks in the run, then the walk
of the quadrant's pixels over those alone; livecnt is the rank of the slot
that terminates a pixel, or the run's length).

At tiles 16 (the one-quadrant case, no gate) and 32, on a frame like the
bench's (small Gaussians over the whole frame, the 50/30/20 opacity
mixture) and on a sparse one (every tenth of its Gaussians), the model is
held to `rasterize_tiles_plain` bit for bit: livecnt and t_final (the
skipped slots would have multiplied T by exactly 1), and color and alpha
(the walk's per-pair weights, put back at their ranks, are summed as the
plain version sums them). It is held to the JAX package's Pallas forward
(`rasterize_pixels_pallas` in interpret mode) at the JAX package's budget
(tests/test_rasterize_pallas.py): atol 2e-5, 5e-5 on a dense scene. The
CUDA kernel is held against the plain version on a GPU by
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.ops.rasterize_pallas import rasterize_pixels_pallas
from freegaussian_tpu_torch.ops.rasterize_cuda import (
    CONTRACT_TILE,
    rasterize_tiles_plain,
    rasterize_tiles_quadrants_plain,
)
from freegaussian_tpu_torch.ops.tiles import build_intersections
from torch_port_helpers import bench_like_scene, clustered_scene_2d

W, H = 96, 64  # 3 x 2 tiles of 32, 6 x 4 of 16


def _args(scene, width, height, tile_size):
    m, con, col, op, dep, rad = [torch.tensor(a) for a in scene]
    r = rad.float()
    isect = build_intersections(m, r, dep, width, height, tile_size)
    return (m, con, col, op, r, isect.gauss_ids, isect.tile_offsets, width, height, tile_size), isect


def _quadrants_missed(args, isect):
    """Slots whose 16-px contract bbox misses at least one quadrant of their
    32-px tile (the slots the tile-32 gate drops there)."""
    m, _, _, _, r, ids, offs = args[:7]
    tiles_w = -(-args[7] // 32)
    tile = torch.repeat_interleave(torch.arange(offs.shape[0] - 1), (offs[1:] - offs[:-1]).long())
    g, rr = m[ids.long()], r[ids.long()]
    lo, hi = torch.floor((g - rr[:, None]) / CONTRACT_TILE), torch.ceil((g + rr[:, None]) / CONTRACT_TILE)
    q0 = torch.stack([(tile % tiles_w) * 2, (tile // tiles_w) * 2], dim=1).float()
    covers_both = (lo <= q0) & (hi >= q0 + 2)  # both contract tiles of the tile along x, along y
    return int((~covers_both.all(1)).sum())


@pytest.mark.parametrize("channels", [3, 5])
@pytest.mark.parametrize("frame", ["bench", "sparse"])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_quadrant_model_matches_plain(tile_size, frame, channels):
    scene = bench_like_scene(seed=channels, channels=channels)
    if frame == "sparse":
        scene = tuple(a[::10] for a in scene)
    args, isect = _args(scene, W, H, tile_size)
    got = rasterize_tiles_quadrants_plain(*args)
    want = rasterize_tiles_plain(*args)
    for name, a, b in zip(("color", "alpha", "livecnt", "t_final"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), (name, float((a.double() - b.double()).abs().max()))
    livecnt, t_final = got[2], got[3]
    assert (livecnt > 0).any() and torch.isfinite(got[0]).all()
    if frame == "bench":
        assert (t_final <= 1e-3).any()  # some pixels terminate: livecnt is a terminating slot's rank there
    if tile_size == 32:
        assert _quadrants_missed(args, isect) > 0  # the gate compacts the runs


def test_quadrant_model_writes_empty_tiles():
    """A frame whose Gaussians all sit in one corner tile, and a frame with
    no intersection at all: every pixel is written (zeros, livecnt 0, T 1
    where nothing reaches it)."""
    scene = bench_like_scene(n=40, seed=9)
    scene = (np.clip(scene[0], 0, 20).astype(np.float32),) + scene[1:]
    for empty in (False, True):
        s = scene if not empty else scene[:5] + (np.zeros_like(scene[5]),)
        args, isect = _args(s, W, H, 32)
        assert (isect.num_isects == 0) == empty
        got = rasterize_tiles_quadrants_plain(*args)
        want = rasterize_tiles_plain(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        far = (slice(40, None), slice(40, None))  # no Gaussian reaches here
        assert torch.all(got[0][far] == 0) and torch.all(got[2][far] == 0) and torch.all(got[3][far] == 1)


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("dense", [False, True])
def test_quadrant_model_matches_jax_pallas(dense, tile_size):
    if dense:
        # heavy overlap at opacity 0.5-0.999: most pixels terminate
        scene, (w, h), atol = clustered_scene_2d(n=300, width=32, height=32, seed=3, dense=True), (32, 32), 5e-5
    else:
        scene, (w, h), atol = clustered_scene_2d(n=120, seed=4, channels=3), (48, 32), 2e-5
    r_pal, a_pal, _ = rasterize_pixels_pallas(*map(jnp.asarray, scene), w, h, tile_size=tile_size, interpret=True)
    args, _ = _args(scene, w, h, tile_size)
    color, alpha, _, _ = rasterize_tiles_quadrants_plain(*args)
    np.testing.assert_allclose(color.numpy(), np.asarray(r_pal), atol=atol)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(a_pal)[..., 0], atol=atol)
    assert alpha.max() > 0.9
