"""The port's differentiable pixel stage and `rasterization` against the JAX
package's gradients, on the CPU.

The compositor's backward runs its plain version here (autograd through the
plain compositor with respect to the gathered per-intersection rows, then the
deterministic per-Gaussian reduction); it is held against `jax.grad` of
`rasterize_pixels_pallas` (the Pallas backward `_bwd_kernel_rev` in
interpret mode) at tile 16 and 32, for means2d, conics, colors and
opacities, and for the absgrad sink. Budgets are the JAX package's
(tests/test_rasterize_pallas.py): rtol 1e-3 / atol 1e-4, and 2e-3 / 2e-4 on
the dense-termination scene. The CUDA kernel is held against the plain
version on a GPU by tests/test_torch_kernels_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.ops.rasterize import rasterization as j_rasterization
from freegaussian_tpu.ops.rasterize_pallas import _reduce_rows_by_gid as j_reduce_rows_by_gid
from freegaussian_tpu.ops.rasterize_pallas import rasterize_pixels_pallas
from freegaussian_tpu_torch.ops import rasterize_cuda
from freegaussian_tpu_torch.ops.rasterize import rasterization as t_rasterization
from freegaussian_tpu_torch.ops.rasterize_cuda import (
    GRAD_ROW_HEAD,
    rasterize_pixels,
    rasterize_tiles,
    rasterize_tiles_bwd,
    reduce_rows_by_gid,
)
from freegaussian_tpu_torch.ops.tiles import build_intersections
from torch_port_helpers import camera_arrays, clustered_scene_2d, gaussian_scene_3d, jax_camera, torch_camera

W, H = 48, 32


def uniform_scene(n=80, width=W, height=H, seed=0, channels=3, opac_scale=0.9):
    """Gaussians spread over the frame (the pattern of
    tests/test_rasterize_pallas.py:make_scene), from a numpy seed."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(size=(n, 2)) * np.array([width, height])
    a = rng.uniform(0.05, 0.6, size=n)
    c = rng.uniform(0.05, 0.6, size=n)
    b = rng.uniform(-0.5, 0.5, size=n) * np.sqrt(a * c)
    f = lambda x: np.asarray(x, np.float32)
    radii = np.full(n, 9, np.int32)
    radii[::11] = 0
    return (
        f(means2d), f(np.stack([a, b, c], -1)), f(rng.uniform(size=(n, channels))),
        f(rng.uniform(size=n) * opac_scale), f(np.linspace(1.0, 5.0, n)), radii,
    )


@functools.lru_cache(maxsize=None)
def _jax_grads_fn(width, height, tile_size, dense):
    def loss(m, c, col, op, sink, depths, radii, target):
        render, alpha, _ = rasterize_pixels_pallas(
            m, c, col, op, depths, radii, width, height, tile_size=tile_size, interpret=True, means2d_sink=sink,
        )
        if dense:
            return jnp.sum(jnp.abs(render - target)) + jnp.sum(alpha)
        return jnp.sum((render - target) ** 2) + 0.3 * jnp.sum(alpha**2)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))


def _port_grads(scene, target, width, height, tile_size, dense):
    m, con, col, op, dep, rad = [torch.tensor(a) for a in scene]
    leaves = [t.requires_grad_(True) for t in (m, con, col, op)]
    sink = torch.zeros_like(m, requires_grad=True)
    render, alpha, _ = rasterize_pixels(*leaves, dep, rad.float(), width, height, tile_size=tile_size, means2d_sink=sink)
    tgt = torch.tensor(target)
    if dense:
        loss = (render - tgt).abs().sum() + alpha.sum()
    else:
        loss = ((render - tgt) ** 2).sum() + 0.3 * (alpha**2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves + [sink])]


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("dense", [False, True])
def test_backward_and_absgrad_match_jax_pallas(tile_size, dense):
    if dense:
        # heavy overlap at opacity up to 0.999: most pixels terminate
        scene, (w, h) = uniform_scene(n=200, width=32, height=32, seed=7, opac_scale=0.999, channels=3), (32, 32)
        rtol, atol = 2e-3, 2e-4
    else:
        scene, (w, h) = uniform_scene(n=80, seed=1, channels=5), (W, H)
        rtol, atol = 1e-3, 1e-4
    C = scene[2].shape[1]
    target = np.random.default_rng(9).uniform(size=(h, w, C)).astype(np.float32)
    m, con, col, op, dep, rad = map(jnp.asarray, scene)
    want = _jax_grads_fn(w, h, tile_size, dense)(m, con, col, op, jnp.zeros_like(m), dep, rad, jnp.asarray(target))
    got = _port_grads(scene, target, w, h, tile_size, dense)
    for name, a, b in zip(("means2d", "conics", "colors", "opacities", "absgrad"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=name)
    # absgrad sums |per-tile means2d gradient|: it dominates the signed gradient
    assert np.all(got[4] >= np.abs(got[0]) - 1e-5)
    assert np.abs(got[4]).max() > 1e-2


def test_absgrad_depends_on_the_kernel_tile():
    """At tile 32 the absgrad sums |d means2d| over 32-px tiles, as the JAX
    kernel does: a Gaussian straddling a 16-px boundary inside one 32-px
    tile gets less than at tile 16, never more."""
    scene = clustered_scene_2d(n=120, seed=2, channels=3)
    target = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)
    a16 = _port_grads(scene, target, W, H, 16, False)[4]
    a32 = _port_grads(scene, target, W, H, 32, False)[4]
    assert np.all(a32 <= a16 + 1e-5) and (a32 < a16 - 1e-4).any()


def test_backward_rows_layout_and_every_row_written():
    """One row per intersection: [d mx, d my, d conic (3), d opacity,
    |d mx|, |d my|, d colors]; slots past every pixel's termination hold
    exact zeros, and the reduction sums rows per Gaussian."""
    scene = clustered_scene_2d(n=200, width=40, height=24, seed=11, dense=True, channels=4)
    # six broad opaque Gaussians in front of everything: every pixel
    # terminates within them, so the rest of each tile's run is dead
    front = (np.tile([[20.0, 12.0]], (6, 1)), np.tile([[1e-3, 0.0, 1e-3]], (6, 1)), np.full((6, 4), 0.5),
             np.full(6, 0.99), np.full(6, 0.5), np.full(6, 40))
    scene = [np.concatenate([f.astype(a.dtype), a]) for f, a in zip(front, scene)]
    m, con, col, op, dep, rad = [torch.tensor(a) for a in scene]
    r = rad.float()
    isect = build_intersections(m, r, dep, 40, 24, 16)
    args = (m, con, col, op, r, isect.gauss_ids, isect.tile_offsets)
    _, _, livecnt, t_final = rasterize_tiles(*args, 40, 24, 16)
    g = torch.Generator().manual_seed(0)
    g_color, g_alpha = torch.randn(24, 40, 4, generator=g), torch.randn(24, 40, generator=g)
    before = dict(rasterize_cuda.LAUNCHES)
    rows = rasterize_tiles_bwd(*args, livecnt, t_final, g_color, g_alpha, 40, 24, 16)
    assert rasterize_cuda.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert rows.shape == (isect.num_isects, GRAD_ROW_HEAD + 4)
    torch.testing.assert_close(rows[:, 6:8], rows[:, 0:2].abs())
    # rank of each slot in its tile's run vs the deepest livecnt of the tile
    offs = isect.tile_offsets.long()
    tile_of_slot = torch.repeat_interleave(torch.arange(len(offs) - 1), offs[1:] - offs[:-1])
    rank = torch.arange(isect.num_isects) - offs[tile_of_slot]
    lc_tiles = torch.stack(
        [livecnt[ty * 16 : (ty + 1) * 16, tx * 16 : (tx + 1) * 16].max() for ty in range(2) for tx in range(3)]
    )
    dead = rank >= lc_tiles[tile_of_slot]
    assert dead.any() and torch.all(rows[dead] == 0)
    g_gauss = reduce_rows_by_gid(rows, isect.gauss_ids, isect.offsets, isect.counts)
    exact = torch.zeros(206, rows.shape[1], dtype=torch.float64).index_add_(0, isect.gauss_ids.long(), rows.double())
    torch.testing.assert_close(g_gauss.double(), exact, rtol=1e-5, atol=1e-5)


def test_reduce_rows_by_gid_rounds_once_and_matches_jax():
    """The per-Gaussian reduction against the JAX package's on 60k seeded
    rows (signed columns and non-negative absgrad-like ones) in 3000 groups
    of 0-39 rows: the port's sum is the float64 sum rounded once to f32
    (within one ulp, plus the f64 prefix's own rounding); the JAX package's
    f32 prefix sum is within log2(I) eps of the running prefix of |rows| at
    each group's end (the error of a log-depth scan of that length), and so
    within the same of the port's."""
    rng = np.random.default_rng(21)
    n, d = 3000, 13
    counts = rng.integers(0, 40, n).astype(np.int32)
    total = int(counts.sum())
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    gids = np.repeat(np.arange(n, dtype=np.int32), counts)[rng.permutation(total)]
    rows = rng.uniform(0, 2, (total, d)).astype(np.float32)
    rows[:, :6] = rng.normal(size=(total, 6))
    exact = np.zeros((n, d))
    np.add.at(exact, gids, rows.astype(np.float64))
    prefix = np.cumsum(np.abs(rows[np.argsort(gids, kind="stable")]).astype(np.float64), axis=0)
    prefix_end = np.concatenate([np.zeros((1, d)), prefix])[offsets + counts]
    eps = float(np.finfo(np.float32).eps)
    got = reduce_rows_by_gid(*map(torch.tensor, (rows, gids, offsets, counts))).numpy()
    want = np.asarray(j_reduce_rows_by_gid(*map(jnp.asarray, (rows, gids, offsets, counts))))[:n]
    assert got.dtype == np.float32 and got.shape == (n, d)
    assert np.all(np.abs(got - exact) <= eps * np.abs(exact) + 2.0**-40 * prefix_end)
    scan = np.log2(total) * eps * prefix_end
    assert np.all(np.abs(want - exact) <= scan)
    assert np.all(np.abs(got - want) <= scan)


def test_pixel_stage_gradcheck_in_float64():
    """The plain backward is exact autograd: a float64 finite-difference
    check of the pixel stage on a scene without termination."""
    scene = uniform_scene(n=12, width=16, height=16, seed=3, opac_scale=0.5)
    m, con, col, op, dep, rad = [torch.tensor(a, dtype=torch.float64) for a in scene]
    isect = build_intersections(m.float(), rad.float(), dep.float(), 16, 16, 16)

    def fn(m_, con_, col_, op_):
        rows = torch.cat([m_, con_, op_[:, None], col_], 1)[isect.gauss_ids.long()]
        color, alpha, _, _ = rasterize_cuda._composite_plain(
            rows, rad.double()[isect.gauss_ids.long()], isect.tile_offsets, 16, 16, 16
        )
        return color, alpha

    inputs = tuple(t.clone().requires_grad_(True) for t in (m, con, col, op))
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_rasterization_grad(tile_size, backend):
    def loss(means, quats, scales, opac, sh, sink, viewmat, K, alive, target):
        render, alpha, _ = j_rasterization(
            means, quats, scales, opac, sh, viewmat[None], K[None], W, H, tile_size=tile_size,
            sh_degree=3, alive=alive, means2d_sink=sink, backend=backend, render_mode="RGB",
        )
        return jnp.sum((render[0] - target) ** 2) + jnp.sum(alpha)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5)))


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_rasterization_gradients_match_jax(backend):
    """Autograd through projection, SH and the pixel stage, with dead padded
    slots (all-zero rows) in the batch: gradients finite, and equal to the
    JAX package's. With backend="reference" the sink carries the signed
    means2d gradient, as the JAX oracle backend gives it."""
    params, alive = gaussian_scene_3d(n=120, seed=4, capacity=130)
    scales = np.exp(params["scales"])
    opac = (1.0 / (1.0 + np.exp(-params["opacities"][:, 0]))).astype(np.float32)
    sh = np.concatenate([params["features_dc"][:, None], params["features_rest"].reshape(130, -1, 3)], axis=1)
    arrs = camera_arrays()
    target = np.random.default_rng(2).uniform(size=(H, W, 3)).astype(np.float32)
    inputs = (params["means"], params["quats"], scales, opac, sh)
    jc = jax_camera(arrs)
    want = _jax_rasterization_grad(16, backend)(
        *map(jnp.asarray, inputs), jnp.zeros((130, 2)), jc.viewmat, jc.K, jnp.asarray(alive), jnp.asarray(target)
    )
    tc = torch_camera(arrs)
    leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
    sink = torch.zeros((130, 2), requires_grad=True)
    render, alpha, _ = t_rasterization(
        *leaves, tc.viewmat[None], tc.K[None], W, H, tile_size=16, sh_degree=3, alive=torch.tensor(alive),
        means2d_sink=sink, backend=backend, render_mode="RGB",
    )
    loss = ((render[0] - torch.tensor(target)) ** 2).sum() + alpha.sum()
    got = torch.autograd.grad(loss, leaves + [sink])
    for name, a, b in zip(("means", "quats", "scales", "opacities", "sh", "sink"), got, want):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all(), name
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * scale, err_msg=name)
    assert np.all(got[0].numpy()[~alive] == 0) and np.abs(got[0].numpy()).max() > 0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_deform_field_weight_gradients_match_jax(bf16):
    """Autograd through the deform field (depth 2, width 32: the skip feeds
    the heads) against jax.grad of the flax field, from one flax init: f32
    weight gradients in both modes. Tolerance relative to each tensor's
    largest entry: 1e-4 in f32; 2e-2 in bf16, where the trunk rounds to 8
    mantissa bits and the f32 accumulation order inside a product may flip
    one rounding (tests/test_torch_fields.py)."""
    from freegaussian_tpu.models.fields import DeformField as JField
    from freegaussian_tpu_torch.models.fields import DeformField as TField
    from freegaussian_tpu_torch.models.torch_compat import deform_state_from_flax

    field = JField(depth=2, width=32, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    dvars = field.init(jax.random.PRNGKey(3), jnp.zeros((1, 3)), jnp.zeros((1, 1)))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    t = np.full((1, 1), 0.4, np.float32)
    cots = [rng.normal(size=s).astype(np.float32) for s in ((64, 3), (64, 3), (64, 1), (64, 4), (64, 3), (64, 3))]

    def j_loss(v):
        d, rot, scale = field.apply(v, jnp.asarray(x), jnp.asarray(t))
        outs = (d.w, d.v, d.theta, rot, scale, d.apply(jnp.asarray(x)))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    want = deform_state_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(j_loss))(dvars)))
    deform = TField(depth=2, width=32, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    deform.load_state_dict(deform_state_from_flax(jax.tree.map(np.asarray, dvars)))
    d, rot, scale = deform(torch.tensor(x), torch.tensor(t))
    outs = (d.w, d.v, d.theta, rot, scale, d.apply(torch.tensor(x)))
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots))
    names, params = zip(*deform.named_parameters())
    got = torch.autograd.grad(loss, params)
    rel = 2e-2 if bf16 else 1e-4
    for name, g in zip(names, got):
        assert g.dtype == torch.float32, name
        w = want[name]
        torch.testing.assert_close(g, w, rtol=rel, atol=rel * float(w.abs().max()), msg=name)
