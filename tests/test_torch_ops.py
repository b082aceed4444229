"""PyTorch port vs the JAX package: math, cameras, projection, SH, tile
bounds and binning, on identical seeded numpy inputs (CPU).

Tolerances: rtol 1e-5 / atol 1e-6 for the float ops (both sides run the same
f32 formulas; the difference is summation order in the small matmuls), exact
equality for the integer outputs (radii, sorted ids, tile offsets)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.ops import math as jm
from freegaussian_tpu.ops.projection import project_gaussians as j_project
from freegaussian_tpu.ops.rasterize_ref import tile_bounds as j_tile_bounds
from freegaussian_tpu.ops.sh import eval_sh_colors as j_eval_sh
from freegaussian_tpu.ops.tiles import build_intersections as j_build
from freegaussian_tpu_torch.ops import math as tm
from freegaussian_tpu_torch.ops.projection import project_gaussians as t_project
from freegaussian_tpu_torch.ops.rasterize_ref import tile_bounds as t_tile_bounds
from freegaussian_tpu_torch.ops.sh import eval_sh_colors as t_eval_sh
from freegaussian_tpu_torch.ops.sh import sh_colors_for_camera
from freegaussian_tpu_torch.ops.tiles import build_intersections as t_build
from torch_port_helpers import (
    camera_arrays,
    clustered_scene_2d,
    gaussian_scene_3d,
    jax_camera,
    torch_camera,
)

RTOL, ATOL = 1e-5, 1e-6
REPO = Path(__file__).resolve().parents[1]


def close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(), rtol=rtol, atol=atol, err_msg=msg)


def test_math_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, size=(50, 3)).astype(np.float32)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    c2w = rng.normal(size=(4, 4, 4)).astype(np.float32)
    close(jm.safe_norm(jnp.asarray(x), axis=-1), tm.safe_norm(torch.tensor(x), dim=-1))
    close(jm.quat_to_rotmat(jnp.asarray(q)), tm.quat_to_rotmat(torch.tensor(q)))
    close(jm.quats_to_covar(jnp.asarray(s), jnp.asarray(q)), tm.quats_to_covar(torch.tensor(s), torch.tensor(q)))
    for freqs in (6, 10):
        close(jm.positional_embed(jnp.asarray(x), freqs), tm.positional_embed(torch.tensor(x), freqs))
    close(jm.get_viewmat(jnp.asarray(c2w)), tm.get_viewmat(torch.tensor(c2w)))
    assert [tm.num_sh_bases(d) for d in range(5)] == [jm.num_sh_bases(d) for d in range(5)]


def test_camera_matches_jax():
    arrs = camera_arrays(width=64, height=40)
    jc, tc = jax_camera(arrs), torch_camera(arrs)
    close(jc.K, tc.K)
    close(jc.viewmat, tc.viewmat)
    jd, td = jc.downscaled(2), tc.downscaled(2)
    close(jd.K, td.K)
    assert (jd.width, jd.height) == (td.width, td.height) == (32, 20)


@pytest.mark.parametrize("antialiased", [False, True], ids=["classic", "antialiased"])
def test_projection_matches_jax(antialiased):
    params, alive = gaussian_scene_3d(n=300, seed=1, capacity=320)
    arrs = camera_arrays()
    jc, tc = jax_camera(arrs), torch_camera(arrs)
    scales = np.exp(params["scales"])
    pj = j_project(
        jnp.asarray(params["means"]), jnp.asarray(params["quats"]), jnp.asarray(scales),
        jc.viewmat, jc.K, 48, 32, calc_compensations=antialiased, alive=jnp.asarray(alive),
    )
    pt = t_project(
        torch.tensor(params["means"]), torch.tensor(params["quats"]), torch.tensor(scales),
        tc.viewmat, tc.K, 48, 32, calc_compensations=antialiased, alive=torch.tensor(alive),
    )
    for name in pj._fields:
        if name == "radii":
            np.testing.assert_array_equal(np.asarray(pj.radii), pt.radii.numpy())
        else:
            close(getattr(pj, name), getattr(pt, name), msg=name)
    assert pt.radii.dtype == torch.int32
    assert int((pt.radii > 0).sum()) > 100  # most of the scene is on screen


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(size=(64, 25, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    close(j_eval_sh(jnp.asarray(coeffs), jnp.asarray(dirs), degree), t_eval_sh(torch.tensor(coeffs), torch.tensor(dirs), degree))


def test_sh_camera_colors_match_jax_formula():
    """Camera position -R^T t and the clip(rgb + 0.5, 0) shift of
    freegaussian_tpu/ops/rasterize.py:177-181."""
    params, _ = gaussian_scene_3d(n=64, seed=2)
    coeffs = np.concatenate([params["features_dc"][:, None], params["features_rest"].reshape(64, 15, 3)], axis=1)
    jc = jax_camera(camera_arrays())
    vm = jc.viewmat
    pos = -vm[:3, :3].T @ vm[:3, 3]
    expect = jnp.clip(j_eval_sh(jnp.asarray(coeffs), jnp.asarray(params["means"]) - pos, 3) + 0.5, 0.0, None)
    got = sh_colors_for_camera(torch.tensor(coeffs), torch.tensor(params["means"]), torch_camera(camera_arrays()).viewmat, 3)
    close(expect, got)


def test_tile_bounds_matches_jax():
    means2d, _, _, opac, _, radii = clustered_scene_2d(n=120, seed=3)
    r = radii.astype(np.float32) * opac  # fractional radii, as tighten_radii gives
    for ts in (16, 32):
        tw, th = -(-48 // ts), -(-32 // ts)
        jb = j_tile_bounds(jnp.asarray(means2d), jnp.asarray(r), ts, tw, th)
        tb = t_tile_bounds(torch.tensor(means2d), torch.tensor(r), ts, tw, th)
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_intersections_matches_jax(tile_size, seed):
    """Identical sorted ids and tile offsets (the single-key sort's tie order
    included); JAX precull off, as its pixel path runs it."""
    means2d, _, _, _, depths, radii = clustered_scene_2d(n=300, seed=seed, dense=True)
    depths[::7] = depths[3]  # exact depth ties
    tb = t_build(torch.tensor(means2d), torch.tensor(radii), torch.tensor(depths), 48, 32, tile_size)
    jb = j_build(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths), 48, 32, tile_size, 1 << 14)
    n = tb.num_isects
    assert n == int(jb.num_isects) and n > 300
    np.testing.assert_array_equal(np.asarray(jb.gauss_ids)[:n], tb.gauss_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jb.tile_ids)[:n], tb.tile_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jb.tile_offsets), tb.tile_offsets.numpy())
    np.testing.assert_array_equal(np.asarray(jb.counts), tb.counts.numpy())
    np.testing.assert_array_equal(np.asarray(jb.offsets), tb.offsets.numpy())


def test_build_intersections_two_key_path_matches_jax():
    """num_tiles >= 2^11 takes the exact (tile, depth) sort."""
    rng = np.random.default_rng(4)
    w, h = 1024, 512  # 64 x 32 = 2048 tiles of 16 px
    n = 400
    means2d = rng.uniform([0, 0], [w, h], size=(n, 2)).astype(np.float32)
    radii = rng.integers(0, 40, size=n).astype(np.int32)
    depths = rng.uniform(0.5, 3.0, size=n).astype(np.float32)
    depths[::5] = depths[1]
    tb = t_build(torch.tensor(means2d), torch.tensor(radii), torch.tensor(depths), w, h, 16)
    jb = j_build(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths), w, h, 16, 1 << 14)
    assert tb.num_tiles == 2048
    n_is = tb.num_isects
    assert n_is == int(jb.num_isects)
    np.testing.assert_array_equal(np.asarray(jb.gauss_ids)[:n_is], tb.gauss_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jb.tile_offsets), tb.tile_offsets.numpy())


def test_build_intersections_culls_non_positive_depth():
    means2d, _, _, _, depths, radii = clustered_scene_2d(n=60, seed=5)
    depths[:10] = -1.0
    depths[10:12] = 0.0
    tb = t_build(torch.tensor(means2d), torch.tensor(radii), torch.tensor(depths), 48, 32, 16)
    assert not np.isin(np.arange(12), tb.gauss_ids.numpy()).any()
    assert (tb.counts[:12] == 0).all()


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, flax or the JAX package."""
    code = r"""
import importlib, pkgutil, sys
import freegaussian_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "freegaussian_tpu")]
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("freegaussian_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_default_device_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from freegaussian_tpu_torch.device import resolve_device
    from freegaussian_tpu_torch.models.splat_model import SplatConfig, SplatModel
    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint
    from freegaussian_tpu_torch.viewer.server import orbit_camera

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        SplatModel(SplatConfig(), 4)
    with pytest.raises(RuntimeError, match="cuda"):
        orbit_camera(0.0, 0.0, 4.0, width=8, height=8)
    model = SplatModel(SplatConfig(), 4, device="cpu")
    from freegaussian_tpu_torch.models.torch_compat import export_reference_checkpoint

    path = export_reference_checkpoint(tmp_path / "c.ckpt", model.params, model.alive, deform=model.deform)
    with pytest.raises(RuntimeError, match="cuda"):
        load_reference_checkpoint(path)
