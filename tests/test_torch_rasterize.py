"""The port's pixel stage and `rasterization` vs the JAX package.

On the CPU the tile compositor runs its plain PyTorch version; it is held
against the Pallas kernel in interpret mode and the dense jnp oracle with the
JAX package's own budget (tests/test_rasterize_pallas.py:39-169): atol 2e-5,
5e-5 on the dense scene (termination flips at f32 rounding). The CUDA kernel
is held against the plain version on a GPU by tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.ops.rasterize import rasterization as j_rasterization
from freegaussian_tpu.ops.rasterize_pallas import rasterize_pixels_pallas
from freegaussian_tpu.ops.rasterize_ref import rasterize_pixels_reference as j_reference
from freegaussian_tpu_torch.ops import rasterize_cuda
from freegaussian_tpu_torch.ops.rasterize import rasterization as t_rasterization
from freegaussian_tpu_torch.ops.rasterize import tighten_radii
from freegaussian_tpu_torch.ops.rasterize_cuda import (
    rasterize_pixels,
    rasterize_tiles,
    rasterize_tiles_plain,
)
from freegaussian_tpu_torch.ops.rasterize_ref import (
    MAX_ALPHA,
    TRANSMITTANCE_EPS,
    ALPHA_THRESHOLD,
    rasterize_pixels_reference as t_reference,
)
from freegaussian_tpu_torch.ops.tiles import build_intersections
from torch_port_helpers import camera_arrays, clustered_scene_2d, gaussian_scene_3d, jax_camera, torch_camera

W, H = 48, 32


def _torch(scene):
    return [torch.tensor(a) for a in scene]


def _plain_pixels(scene, width, height, tile_size):
    m, con, col, op, dep, rad = _torch(scene)
    render, alpha, _ = rasterize_pixels(m, con, col, op, dep, rad.float(), width, height, tile_size=tile_size)
    return render.numpy(), alpha.numpy()


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("channels", [3, 4, 5])
def test_plain_pixel_stage_matches_pallas_and_oracle(channels, tile_size):
    scene = clustered_scene_2d(n=120, seed=channels, channels=channels)
    render, alpha = _plain_pixels(scene, W, H, tile_size)
    r_pal, a_pal, _ = rasterize_pixels_pallas(*map(jnp.asarray, scene), W, H, tile_size=tile_size, interpret=True)
    r_ref, a_ref, _ = j_reference(*map(jnp.asarray, scene), W, H)
    assert render.shape == (H, W, channels) and alpha.shape == (H, W, 1)
    np.testing.assert_allclose(render, np.asarray(r_pal), atol=2e-5)
    np.testing.assert_allclose(alpha, np.asarray(a_pal), atol=2e-5)
    np.testing.assert_allclose(render, np.asarray(r_ref), atol=2e-5)
    np.testing.assert_allclose(alpha, np.asarray(a_ref), atol=2e-5)
    assert alpha.max() > 0.9  # some pixels saturate, some terminate


@pytest.mark.parametrize("tile_size", [16, 32])
def test_plain_pixel_stage_dense_scene(tile_size):
    """Heavy overlap: early termination in most pixels."""
    scene = clustered_scene_2d(n=300, width=32, height=32, seed=3, dense=True)
    render, alpha = _plain_pixels(scene, 32, 32, tile_size)
    r_ref, a_ref, _ = j_reference(*map(jnp.asarray, scene), 32, 32)
    r_pal, a_pal, _ = rasterize_pixels_pallas(*map(jnp.asarray, scene), 32, 32, tile_size=tile_size, interpret=True)
    for r, a in ((r_ref, a_ref), (r_pal, a_pal)):
        np.testing.assert_allclose(render, np.asarray(r), atol=5e-5)
        np.testing.assert_allclose(alpha, np.asarray(a), atol=5e-5)
    assert (alpha > 0.999).mean() > 0.25  # terminated pixels


def test_dense_reference_matches_jax_oracle():
    scene = clustered_scene_2d(n=120, seed=7, channels=4)
    m, con, col, op, dep, rad = _torch(scene)
    r_t, a_t, t_t = t_reference(m, con, col, op, dep, rad, W, H, pixel_chunk=500)
    r_j, a_j, t_j = j_reference(*map(jnp.asarray, scene), W, H)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=2e-6)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=2e-6)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=2e-6)


def _sequential_tiles(scene, ids, offsets, width, height, tile_size):
    """Per-pixel loop over each tile's sorted run (the compositing contract
    written out), giving livecnt and t_final."""
    m, con, _, op, _, rad = scene
    tiles_w = -(-width // tile_size)
    livecnt = np.zeros((height, width), np.int64)
    t_final = np.ones((height, width), np.float64)
    for y in range(height):
        for x in range(width):
            tile = (y // tile_size) * tiles_w + x // tile_size
            T, walked = 1.0, 0
            for j in range(offsets[tile], offsets[tile + 1]):
                g = ids[j]
                dx, dy = m[g, 0] - (x + 0.5), m[g, 1] - (y + 0.5)
                sigma = 0.5 * (con[g, 0] * dx * dx + con[g, 2] * dy * dy) + con[g, 1] * dx * dy
                alpha = min(MAX_ALPHA, op[g] * np.exp(-sigma))
                cx0, cx1 = np.floor((m[g, 0] - rad[g]) / 16), np.ceil((m[g, 0] + rad[g]) / 16)
                cy0, cy1 = np.floor((m[g, 1] - rad[g]) / 16), np.ceil((m[g, 1] + rad[g]) / 16)
                in_box = cx0 <= x // 16 < cx1 and cy0 <= y // 16 < cy1
                if sigma >= 0 and alpha >= ALPHA_THRESHOLD and in_box:
                    if T * (1 - alpha) <= TRANSMITTANCE_EPS:
                        break
                    T *= 1 - alpha
                walked += 1
            livecnt[y, x], t_final[y, x] = walked, T
    return livecnt, t_final


@pytest.mark.parametrize("tile_size", [16, 32])
def test_plain_tiles_livecnt_and_final_transmittance(tile_size, monkeypatch):
    """The two outputs the backward will read: livecnt (slots walked before
    termination) and t_final (transmittance after the last composite)."""
    scene = clustered_scene_2d(n=200, width=40, height=24, seed=11, dense=True)
    m, con, col, op, dep, rad = _torch(scene)
    r = rad.float()
    isect = build_intersections(m, r, dep, 40, 24, tile_size)
    monkeypatch.setattr(rasterize_cuda, "PLAIN_BATCH_ELEMENTS", 4096)
    color, alpha, livecnt, t_final = rasterize_tiles_plain(
        m, con, col, op, r, isect.gauss_ids, isect.tile_offsets, 40, 24, tile_size
    )
    exp_cnt, exp_t = _sequential_tiles(
        scene, isect.gauss_ids.numpy(), isect.tile_offsets.numpy(), 40, 24, tile_size
    )
    assert livecnt.dtype == torch.int32
    np.testing.assert_array_equal(livecnt.numpy(), exp_cnt)
    np.testing.assert_allclose(t_final.numpy(), exp_t, atol=2e-6)
    np.testing.assert_allclose(t_final.numpy(), 1.0 - alpha.numpy(), atol=2e-6)
    assert (exp_t <= 0.01).any() and (exp_cnt > 0).all()


def test_plain_tiles_batching_is_invisible(monkeypatch):
    """Small batches (many per call) give the same outputs as one batch."""
    scene = clustered_scene_2d(n=150, seed=12, channels=4)
    m, con, col, op, dep, rad = _torch(scene)
    r = rad.float()
    isect = build_intersections(m, r, dep, W, H, 16)
    args = (m, con, col, op, r, isect.gauss_ids, isect.tile_offsets, W, H, 16)
    monkeypatch.setattr(rasterize_cuda, "PLAIN_BATCH_ELEMENTS", 1 << 24)
    one = rasterize_tiles_plain(*args)
    monkeypatch.setattr(rasterize_cuda, "PLAIN_BATCH_ELEMENTS", 256 * 8)
    many = rasterize_tiles_plain(*args)
    assert torch.equal(one[2], many[2])  # livecnt
    for a, b in zip(one, many):
        # the color sum over K pads to each batch's own K_max: f32 sum order only
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_empty_tiles_are_written():
    """Every pixel is written, empty tiles and empty frames included."""
    scene = clustered_scene_2d(n=20, seed=13)
    m, con, col, op, dep, rad = _torch(scene)
    r = torch.zeros_like(rad, dtype=torch.float32)  # everything culled
    isect = build_intersections(m, r, dep, W, H, 32)
    assert isect.num_isects == 0
    color, alpha, livecnt, t_final = rasterize_tiles(
        m, con, col, op, r, isect.gauss_ids, isect.tile_offsets, W, H, 32
    )
    assert torch.all(color == 0) and torch.all(alpha == 0)
    assert torch.all(livecnt == 0) and torch.all(t_final == 1)


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    scene = clustered_scene_2d(n=30, seed=14)
    m, con, col, op, dep, rad = _torch(scene)
    r = rad.float()
    isect = build_intersections(m, r, dep, W, H, 16)
    args = [m, con, col, op, r, isect.gauss_ids, isect.tile_offsets, W, H, 16]
    before = dict(rasterize_cuda.LAUNCHES)
    rasterize_tiles(*args)  # CPU tensors: the plain version, no launch
    assert rasterize_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="tile_size"):
        rasterize_tiles(*args[:-1], 8)
    bad = list(args)
    bad[2] = torch.zeros((30, 9))
    with pytest.raises(ValueError, match="channels"):
        rasterize_tiles(*bad)
    bad = list(args)
    bad[0] = m.double()
    with pytest.raises(TypeError, match="means2d"):
        rasterize_tiles(*bad)
    bad = list(args)
    bad[1] = con.t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        rasterize_tiles(*bad)


def _rasterization_inputs(seed=0, n=150):
    params, alive = gaussian_scene_3d(n=n, seed=seed, capacity=n + 10)
    scales = np.exp(params["scales"])
    opac = 1.0 / (1.0 + np.exp(-params["opacities"][:, 0]))
    k = params["features_rest"].shape[1] // 3 + 1
    sh = np.concatenate([params["features_dc"][:, None], params["features_rest"].reshape(-1, k - 1, 3)], axis=1)
    arrs = camera_arrays()
    return (params["means"], params["quats"], scales, opac.astype(np.float32), sh), alive, arrs


@pytest.mark.parametrize(
    "render_mode,rasterize_mode,tile_size,extra",
    [
        ("RGB", "classic", 16, False),
        ("RGB+ED", "classic", 32, False),
        ("ED", "classic", 16, False),
        ("RGB+ED", "antialiased", 32, False),
        ("RGB+ED", "classic", 16, True),
    ],
)
def test_rasterization_matches_jax_pallas(render_mode, rasterize_mode, tile_size, extra):
    (means, quats, scales, opac, sh), alive, arrs = _rasterization_inputs(seed=tile_size)
    jc, tc = jax_camera(arrs), torch_camera(arrs)
    flow = np.random.default_rng(1).normal(size=(means.shape[0], 2)).astype(np.float32) if extra else None
    kw = dict(
        tile_size=tile_size, render_mode=render_mode, sh_degree=3, rasterize_mode=rasterize_mode,
    )
    jr, ja, ji = j_rasterization(
        *map(jnp.asarray, (means, quats, scales, opac, sh)), jc.viewmat[None], jc.K[None], W, H,
        alive=jnp.asarray(alive), backend="pallas",
        extra_channels=None if flow is None else jnp.asarray(flow), **kw,
    )
    tr, ta, ti = t_rasterization(
        *map(torch.tensor, (means, quats, scales, opac, sh)), tc.viewmat[None], tc.K[None], W, H,
        alive=torch.tensor(alive), extra_channels=None if flow is None else torch.tensor(flow), **kw,
    )
    assert tr.shape == jr.shape and ta.shape == ja.shape
    color = slice(0, tr.shape[-1] - (1 if render_mode != "RGB" else 0))
    np.testing.assert_allclose(tr.numpy()[..., color], np.asarray(jr)[..., color], atol=2e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5)
    if render_mode != "RGB":
        # expected depth = accumulated depth / alpha: compare where alpha is not tiny
        seen = np.asarray(ja)[0, ..., 0] > 0.05
        np.testing.assert_allclose(tr.numpy()[0, ..., -1][seen], np.asarray(jr)[0, ..., -1][seen], rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(ti.radii.numpy(), np.asarray(ji.radii))
    np.testing.assert_allclose(ti.means2d.numpy(), np.asarray(ji.means2d), rtol=1e-5, atol=1e-5)
    assert ti.num_isects == int(ji.num_isects)


def test_tighten_radii_matches_jax():
    from freegaussian_tpu.ops.rasterize import tighten_radii as j_tighten

    rng = np.random.default_rng(3)
    radii = rng.integers(0, 20, size=200).astype(np.int32)
    op = rng.uniform(0.0, 1.0, size=200).astype(np.float32)
    op[:5] = 0.001
    np.testing.assert_allclose(
        tighten_radii(torch.tensor(radii), torch.tensor(op)).numpy(),
        np.asarray(j_tighten(jnp.asarray(radii), jnp.asarray(op))),
        rtol=1e-6,
    )


def test_rasterization_tpu_only_arguments_raise():
    """The multi-chip arguments, once refused, are ported: a band
    (`tile_origin_y`, `proj_height`) renders as the JAX package's band; a
    JAX mesh-axis name for `gather_axis` is refused (the port takes a
    process group, tests/test_torch_parallel.py)."""
    (means, quats, scales, opac, sh), alive, arrs = _rasterization_inputs(n=20)
    tc, jc = torch_camera(arrs), jax_camera(arrs)
    args = (*map(torch.tensor, (means, quats, scales, opac, sh)), tc.viewmat, tc.K, W, H)
    with pytest.raises(TypeError, match="process group"):
        t_rasterization(*args, sh_degree=3, gather_axis="tile")
    kw = dict(sh_degree=3, tile_size=16, render_mode="RGB+ED", backend="reference", tile_origin_y=16, proj_height=H)
    tr, ta, ti = t_rasterization(*args[:-1], 16, **kw)
    jr, ja, ji = j_rasterization(*map(jnp.asarray, (means, quats, scales, opac, sh)), jc.viewmat[None], jc.K[None],
                                 W, 16, **kw)
    np.testing.assert_allclose(tr.numpy()[..., :3], np.asarray(jr)[..., :3], atol=2e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5)
    np.testing.assert_allclose(ti.means2d.numpy(), np.asarray(ji.means2d), rtol=1e-5, atol=1e-5)
    assert ti.num_isects == int(ji.num_isects) > 0


@pytest.mark.parametrize("tile_size", [16, 32])
def test_rasterization_packed_matches_jax(tile_size):
    """`packed=True`: the per-intersection arrays of the binning in (tile,
    depth) order, the JAX package's first `num_isects` entries (its buffer
    is padded to a capacity): ids and tiles equal, the gathered means2d and
    depths within 1e-5; the gathers differentiate into the means."""
    (means, quats, scales, opac, sh), alive, arrs = _rasterization_inputs(seed=tile_size)
    jc, tc = jax_camera(arrs), torch_camera(arrs)
    kw = dict(tile_size=tile_size, render_mode="RGB+ED", sh_degree=3, packed=True)
    _, _, ji = j_rasterization(
        *map(jnp.asarray, (means, quats, scales, opac, sh)), jc.viewmat[None], jc.K[None], W, H,
        alive=jnp.asarray(alive), backend="reference", isect_capacity=8192, **kw,
    )
    t_means = torch.tensor(means, requires_grad=True)
    tr, ta, ti = t_rasterization(
        t_means, *map(torch.tensor, (quats, scales, opac, sh)), tc.viewmat[None], tc.K[None], W, H,
        alive=torch.tensor(alive), **kw,
    )
    n = ti.num_isects
    assert n == int(ji.num_isects) and 0 < n < 8192
    assert ti.gaussian_ids.shape == ti.tile_ids.shape == (n,) and ti.isect_means2d.shape == (n, 2)
    np.testing.assert_array_equal(ti.gaussian_ids.numpy(), np.asarray(ji.gaussian_ids)[:n])
    np.testing.assert_array_equal(ti.tile_ids.numpy(), np.asarray(ji.tile_ids)[:n])
    np.testing.assert_allclose(ti.isect_means2d.detach().numpy(), np.asarray(ji.isect_means2d)[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.isect_depths.detach().numpy(), np.asarray(ji.isect_depths)[:n], rtol=1e-5, atol=1e-5)
    ti.isect_means2d.sum().backward()
    assert t_means.grad is not None and float(t_means.grad.abs().sum()) > 0
