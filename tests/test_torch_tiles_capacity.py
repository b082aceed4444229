"""The port's capacity-bounded binning (`ops/tiles.py:build_intersections`
with a capacity), its ellipse cull and the compositor on padded slot lists,
against the JAX package on the same seeded numpy inputs.

The binning is integer work on the same f32 inputs: ids, tiles, offsets,
counts and num_isects must be equal to the JAX package's, with and without
overflow, with and without the cull (and its precull), and on the 64-bit
key path of frames with 2^11 tiles or more. The per-Gaussian reduction
under overflow is held to JAX's `_reduce_rows_by_gid` at rtol 1e-6 (the
port's prefix sum runs in f64, the JAX package's in f32:
tests/test_torch_train_backward.py). The pixel stage on a padded slot list
is held to the exact-size one, and an overflowing one to the Pallas kernels
in interpret mode at the same capacity, with the budgets of
tests/test_rasterize_pallas.py:39-169 (atol 2e-5 on the image, 1e-4 +
rtol 1e-4 on the gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.ops import tiles as j_tiles
from freegaussian_tpu.ops.rasterize_pallas import _reduce_rows_by_gid as j_reduce_rows_by_gid
from freegaussian_tpu.ops.rasterize_pallas import rasterize_pixels_pallas
from freegaussian_tpu_torch.ops import rasterize_cuda
from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_pixels, reduce_rows_by_gid
from freegaussian_tpu_torch.ops.tiles import build_intersections
from torch_port_helpers import bench_like_scene, clustered_scene_2d

W, H = 48, 32


def _bins(scene, width, height, tile, capacity, cull=False, precull=True):
    """(port, JAX) intersections of one scene."""
    m, con, _, op, dep, rad = scene
    rad = rad.astype(np.float32)
    extra = dict(conics=con, opacities=op, precull=precull) if cull else {}
    t = build_intersections(
        torch.tensor(m), torch.tensor(rad), torch.tensor(dep), width, height, tile, capacity,
        **{k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in extra.items()},
    )
    j = j_tiles.build_intersections(
        jnp.asarray(m), jnp.asarray(rad), jnp.asarray(dep), width, height, tile, capacity,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in extra.items()},
    )
    return t, j


def _assert_bins_equal(t, j):
    for k in ("gauss_ids", "tile_ids", "tile_offsets", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)), err_msg=k)
    assert int(t.num_isects) == int(j.num_isects)
    assert isinstance(t.num_isects, torch.Tensor) and t.num_isects.ndim == 0


@pytest.mark.parametrize("tile", [16, 32])
def test_capacity_binning_matches_jax_and_exact(tile):
    scene = clustered_scene_2d(n=150, seed=tile)
    exact = build_intersections(*map(torch.tensor, (scene[0], scene[5].astype(np.float32), scene[4])), W, H, tile)
    cap = exact.num_isects + 37
    t, j = _bins(scene, W, H, tile, cap)
    _assert_bins_equal(t, j)
    n = exact.num_isects
    assert int(t.num_isects) == n and t.gauss_ids.shape == (cap,)
    # the exact-size binning is the capacity binning's first num_isects slots
    np.testing.assert_array_equal(t.gauss_ids[:n].numpy(), exact.gauss_ids.numpy())
    np.testing.assert_array_equal(t.tile_ids[:n].numpy(), exact.tile_ids.numpy())
    np.testing.assert_array_equal(t.tile_offsets.numpy(), exact.tile_offsets.numpy())
    np.testing.assert_array_equal(t.counts.numpy(), exact.counts.numpy())
    # padding: id N, tile num_tiles, after every real slot
    assert torch.all(t.gauss_ids[n:] == 150) and torch.all(t.tile_ids[n:] == t.num_tiles)


@pytest.mark.parametrize("tile", [16, 32])
def test_overflow_drops_the_jax_packages_pairs(tile):
    scene = clustered_scene_2d(n=150, seed=10 + tile)
    total = build_intersections(*map(torch.tensor, (scene[0], scene[5].astype(np.float32), scene[4])), W, H, tile).num_isects
    cap = total * 3 // 5
    t, j = _bins(scene, W, H, tile, cap)
    assert int(t.num_isects) == total > cap  # the scene overflows this capacity
    _assert_bins_equal(t, j)
    # the kept slots are the first `cap` in expansion order
    assert int(t.tile_offsets[-1]) == cap


@pytest.mark.parametrize("precull", [True, False])
@pytest.mark.parametrize("capacity", [4096, 300])
def test_ellipse_cull_matches_jax(precull, capacity):
    """The cull on an anisotropic bench-like scene (needle conics, dim
    Gaussians): kept pairs, rebased counts and offsets equal to JAX's, with
    room and under overflow; it keeps fewer pairs than the bbox."""
    rng = np.random.default_rng(4)
    m, con, col, op, dep, rad = bench_like_scene(n=400, width=W, height=H, seed=3)
    con = con * rng.uniform(0.2, 3.0, size=(400, 1)).astype(np.float32)  # wider and narrower ellipses
    rad = (rad * 3).astype(np.int32)  # big bboxes: some past the precull's 32 tiles
    scene = (m, con, col, op, dep, rad)
    t, j = _bins(scene, W, H, 16, capacity, cull=True, precull=precull)
    _assert_bins_equal(t, j)
    bbox, _ = _bins(scene, W, H, 16, capacity)
    assert int(t.tile_offsets[-1]) < int(bbox.tile_offsets[-1]) or capacity == 300
    if capacity == 4096:
        assert int(t.tile_offsets[-1]) < int(bbox.num_isects)


def test_many_tiles_take_the_64_bit_key():
    """1296 x 968 at tile 16 is 4941 tiles: the exact (tile, depth) key;
    padding still sorts last."""
    scene = clustered_scene_2d(n=300, width=1296, height=968, seed=5)
    scene = scene[:5] + ((scene[5] * 4).astype(np.int32),)
    t, j = _bins(scene, 1296, 968, 16, 12000)
    assert t.num_tiles >= 1 << 11
    _assert_bins_equal(t, j)
    n = int(t.num_isects)
    assert n < 12000 and torch.all(t.gauss_ids[n:] == 300) and torch.all(t.tile_ids[n:] == t.num_tiles)
    t2, j2 = _bins(scene, 1296, 968, 16, 3000)  # and under overflow
    _assert_bins_equal(t2, j2)


def test_reduce_rows_clamps_under_overflow():
    scene = clustered_scene_2d(n=150, seed=21)
    t, j = _bins(scene, W, H, 16, 384)
    assert int(t.num_isects) > 384
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(384, 11)).astype(np.float32)
    rows[t.gauss_ids.numpy() == 150] = 0.0  # padding rows are zero (the combine's)
    got = reduce_rows_by_gid(torch.tensor(rows), t.gauss_ids, t.offsets, t.counts).numpy()
    want = np.asarray(j_reduce_rows_by_gid(jnp.asarray(rows), j.gauss_ids, j.offsets, j.counts))[:150]
    # each Gaussian's sum is the f64 sum of its kept rows rounded once; the
    # JAX package's f32 prefix sum is within log2(I) eps of the |rows| prefix
    ids = t.gauss_ids.numpy()
    kept = ids < 150
    exact = np.zeros((150, 11))
    np.add.at(exact, ids[kept], rows[kept].astype(np.float64))
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(got, exact, rtol=eps, atol=1e-12)
    prefix_end = np.abs(rows).astype(np.float64).sum(0)[None, :]
    assert np.all(np.abs(got - want) <= np.log2(384) * eps * prefix_end)


def _pixel_grads(scene, capacity, tile=16):
    leaves = [torch.tensor(a, requires_grad=True) for a in (scene[0], scene[1], scene[2], scene[3])]
    sink = torch.zeros((scene[0].shape[0], 2), requires_grad=True)
    render, alpha, n = rasterize_pixels(
        *leaves, torch.tensor(scene[4]), torch.tensor(scene[5]).float(), W, H, tile_size=tile,
        means2d_sink=sink, capacity=capacity,
    )
    g_img = torch.tensor(np.random.default_rng(1).normal(size=render.shape).astype(np.float32))
    ((render * g_img).sum() + alpha.sum()).backward()
    return render.detach(), alpha.detach(), [x.grad for x in leaves + [sink]], n


@pytest.mark.parametrize("tile", [16, 32])
def test_pixel_stage_on_padded_slots_equals_exact(tile):
    scene = clustered_scene_2d(n=120, seed=30 + tile)
    r0, a0, g0, n0 = _pixel_grads(scene, None, tile)
    r1, a1, g1, n1 = _pixel_grads(scene, n0 + 300, tile)
    assert int(n1) == n0
    np.testing.assert_allclose(r1.numpy(), r0.numpy(), atol=2e-5)
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), atol=2e-5)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_overflowing_pixel_stage_matches_pallas():
    """The same kept pairs as the Pallas kernels at the same overflowing
    capacity: image and gradients (means2d, conics, colors, opacities)."""
    scene = clustered_scene_2d(n=150, seed=41)
    cap = 384
    r_t, a_t, g_t, n_t = _pixel_grads(scene, cap)
    assert int(n_t) > cap

    def loss(m, con, col, op):
        r, a, _ = rasterize_pixels_pallas(m, con, col, op, jnp.asarray(scene[4]), jnp.asarray(scene[5]), W, H,
                                          tile_size=16, capacity=cap, interpret=True)
        g_img = jnp.asarray(np.random.default_rng(1).normal(size=r.shape).astype(np.float32))
        return jnp.sum(r * g_img) + jnp.sum(a), (r, a)

    (_, (r_j, a_j)), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*map(jnp.asarray, scene[:4]))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=2e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=2e-5)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_combine_writes_zero_rows_for_padding():
    """The combine's plain twin: a padding slot's row is zero whatever its
    partials hold (the kernel never writes a padding slot's scratch)."""
    rng = np.random.default_rng(2)
    partials = torch.tensor(rng.normal(size=(4, 10, 9)).astype(np.float32))
    ids = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 8], dtype=torch.int32)  # N = 8: the last two are padding
    op = torch.tensor(rng.uniform(0.1, 1.0, size=8).astype(np.float32))
    rows = rasterize_cuda.combine_quadrants_plain(partials, op, ids)
    assert torch.all(rows[8:] == 0) and torch.all(rows[:8, 6:8] >= 0) and rows[:8].abs().sum() > 0


def test_ellipse_cull_knob_in_the_pixel_stage(monkeypatch):
    """`rasterize_cuda.ELLIPSE_CULL` (off by default, as in the JAX
    package) culls the pixel stage's bins when it has a capacity: fewer
    slots walked, the same image within the forward's budget; without a
    capacity the exact-size binning runs uncut."""
    m, con, col, op, dep, rad = bench_like_scene(n=400, width=W, height=H, seed=3)
    con = con * np.random.default_rng(4).uniform(0.2, 3.0, size=(400, 1)).astype(np.float32)
    args = [torch.tensor(a) for a in (m, con, col, op, dep)] + [torch.tensor(rad * 3).float(), W, H]
    seen = []
    real = rasterize_cuda.build_intersections

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(rasterize_cuda, "build_intersections", spy)
    off, _, n_off = rasterize_pixels(*args, tile_size=16, capacity=4096)
    monkeypatch.setattr(rasterize_cuda, "ELLIPSE_CULL", True)
    on, _, n_on = rasterize_pixels(*args, tile_size=16, capacity=4096)
    exact, _, n_exact = rasterize_pixels(*args, tile_size=16)
    assert int(seen[1].tile_offsets[-1]) < int(seen[0].tile_offsets[-1]) == n_exact == int(seen[2].tile_offsets[-1])
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=2e-5)
    np.testing.assert_allclose(exact.numpy(), off.numpy(), atol=2e-5)
