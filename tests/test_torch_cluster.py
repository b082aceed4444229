"""The port's clustering vote (`preprocess/clustering.py`), key-frame registry
and cluster PLY against the JAX package's, on seeded numpy scenes.

The port runs its plain compositor (the CPU path of the CUDA kernel), the
JAX package its dense oracle (`backend="reference"`, as
tests/test_preprocess.py runs the vote). The vote is discrete: a row can
flip between the two where a value sits on a decision boundary within the
two compositors' f32 rounding. Such rows are found on the JAX side
(`torch_port_helpers.vote_boundary_rows`), counted and left out of the
comparison, every other row must be equal:
  - a projected center coordinate within 1e-4 px of a rounding boundary
    (x.5, half to even in both frameworks) or of the frame's edge;
  - a depth difference d_pixel - d_gaussian within 1e-5 * d_gaussian /
    alpha of either window edge (expected depth is accumulated depth /
    alpha, so its rounding grows as alpha falls), alpha being the center
    pixel's (at least 1e-6);
  - with `min_alpha`, the center pixel's alpha within 1e-5 of it.
At most 3% of the live rows may be left out, and the votes must not be
empty. The deform field is f32 (flax on the JAX side, the port's
split-linear twin), as in tests/test_torch_fields.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models.fields import DeformField as JDeformField
from freegaussian_tpu.preprocess import cluster_viz as j_cluster_viz
from freegaussian_tpu.preprocess import clustering as j_clustering
from freegaussian_tpu.preprocess.key_frames import load_key_frames as j_load_key_frames
from freegaussian_tpu_torch.data.ply import read_ply_points, write_ply_points
from freegaussian_tpu_torch.models.splat_model import SplatConfig, make_deform_field
from freegaussian_tpu_torch.models.torch_compat import deform_state_from_flax
from freegaussian_tpu_torch.preprocess import clustering
from freegaussian_tpu_torch.preprocess.cluster_viz import export_cluster_ply
from freegaussian_tpu_torch.preprocess.key_frames import load_key_frames, save_key_frames
from torch_port_helpers import (
    camera_arrays, field_shapes, flax_linear_vars, gaussian_scene_3d, jax_camera, torch_camera, vote_boundary_rows,
)

W, H = 48, 32
M = 3  # attributes; the masks carry M + 1 channels, the background last
EYES = [(0.8, 0.5, 4.0), (-1.0, 0.3, 3.8), (0.2, -0.9, 4.2), (1.5, 1.0, 3.5)]
MAX_EXCLUDED = 0.03


def _scene(seed=0, n=220, capacity=256):
    params, alive = gaussian_scene_3d(n=n, seed=seed, capacity=capacity)
    # a more opaque scene than the default: the center pixels carry depth
    params["opacities"] = params["opacities"] + 1.5
    return params, alive


def _masks(seed, n_frames=len(EYES)):
    """(H, W, M + 1) masks: each attribute a seeded box (they may overlap),
    the background where none is."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_frames):
        m = np.zeros((H, W, M + 1), bool)
        for c in range(M):
            y, x = rng.integers(0, H // 2), rng.integers(0, W // 2)
            m[y : y + rng.integers(H // 3, H), x : x + rng.integers(W // 3, W), c] = True
        m[..., M] = ~m[..., :M].any(-1)
        out.append(m)
    return out


def _cameras(n_frames=len(EYES)):
    return [camera_arrays(W, H, eye=EYES[i], time=i / max(n_frames - 1, 1)) for i in range(n_frames)]


def _deform_pair(seed=5):
    """A seeded f32 depth-2 width-32 deform field, heads x 0.05: (flax
    module, variables, the port's twin)."""
    shapes = field_shapes("deform", depth=2, width=32)
    dvars = flax_linear_vars(np.random.default_rng(seed), shapes, scales=[1.0] * (len(shapes) - 4) + [0.05] * 4)
    port = make_deform_field(SplatConfig(deform_bf16=False), depth=2, width=32)
    port.load_state_dict(deform_state_from_flax(dvars, True), strict=True)
    return JDeformField(depth=2, width=32), jax.tree.map(jnp.asarray, dvars), port


def _tparams(params):
    return {k: torch.tensor(v) for k, v in params.items()}


def _assert_equal_but_boundary(got, want, excluded, alive):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == bool
    n_live = int(np.sum(alive))
    assert excluded.sum() <= MAX_EXCLUDED * n_live, f"{excluded.sum()} of {n_live} rows on a boundary"
    keep = ~excluded
    print(f"rows voted {int(want[keep].any(-1).sum())}, votes {int(want[keep].sum())}, on a boundary {int(excluded.sum())} "
          f"of {n_live}, differing there {int((got != want).any(-1)[excluded].sum())}")
    np.testing.assert_array_equal(got[keep], want[keep])
    assert want[keep].any(), "no votes: the comparison would be empty"
    assert not got[~np.asarray(alive)].any()


@pytest.mark.parametrize(
    "kw", [{}, dict(depth_low=-0.02, depth_high=0.05), dict(min_alpha=0.5)], ids=["reference", "tight", "min_alpha"]
)
def test_vote_one_frame_matches_jax(kw):
    params, alive = _scene()
    arrs = _cameras()[0]
    atrb = _masks(1)[0][..., :M]
    got = clustering.vote_gaussian_masks_one_frame(
        _tparams(params), torch.tensor(alive), torch_camera(arrs), torch.tensor(atrb), **kw
    )
    want = j_clustering.vote_gaussian_masks_one_frame(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive), jax_camera(arrs), jnp.asarray(atrb),
        backend="reference", **kw,
    )
    excluded = vote_boundary_rows(
        params, alive, arrs, low=kw.get("depth_low", -0.1), high=kw.get("depth_high", 1.0),
        min_alpha=kw.get("min_alpha", 0.0),
    )
    _assert_equal_but_boundary(got.numpy(), want, excluded, alive)


def _valids(n_frames, kind):
    """Per-frame mask valids: per channel (the parsers' (M + 1,) rows, one
    attribute invalid in two frames) or the blender annotations' single
    flag (one frame invalid)."""
    out = {}
    for i in range(n_frames):
        if kind == "per_channel":
            v = np.ones(M + 1, bool)
            if i in (1, 2):
                v[i - 1] = False
        else:
            v = np.array([i != 2])
        out[i] = v
    return out


CASES = {
    "or": {},
    "exclusive": dict(exclusive=True),
    "min_vote_frac": dict(min_vote_frac=0.5),
    "exclusive_min_vote_frac": dict(exclusive=True, min_vote_frac=0.5),
    "tight_window": dict(depth_low=-0.02, depth_high=0.05),
    "min_alpha": dict(min_alpha=0.5),
    "valids_per_channel": dict(mask_valids="per_channel"),
    "valids_single_flag": dict(mask_valids="single_flag"),
    "no_background": dict(drop_background=False),
    "dynamic": dict(dynamic=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_gaussians_matches_jax(case):
    kw = dict(CASES[case])
    params, alive = _scene(seed=2)
    cams = _cameras()
    masks = _masks(3)
    if not kw.get("drop_background", True):
        masks = [m[..., :M] for m in masks]
    if "mask_valids" in kw:
        kw["mask_valids"] = _valids(len(cams), kw["mask_valids"])
    dynamic = kw.pop("dynamic", False)
    field, dvars, port_deform = _deform_pair() if dynamic else (None, None, None)

    got = clustering.cluster_gaussians(
        _tparams(params), torch.tensor(alive), dict(enumerate(masks)),
        {i: torch_camera(a) for i, a in enumerate(cams)}, deform=port_deform, **kw,
    )
    want = j_clustering.cluster_gaussians(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        {i: jnp.asarray(m) for i, m in enumerate(masks)}, {i: jax_camera(a) for i, a in enumerate(cams)},
        deform_apply=field.apply if dynamic else None, deform_vars=dvars, dynamic=dynamic,
        backend="reference", **kw,
    )
    excluded = np.zeros(len(alive), bool)
    for a in cams:
        excluded |= vote_boundary_rows(
            params, alive, a, deform=(field, dvars) if dynamic else None, low=kw.get("depth_low", -0.1),
            high=kw.get("depth_high", 1.0), min_alpha=kw.get("min_alpha", 0.0),
        )
    _assert_equal_but_boundary(got.numpy(), want, excluded, alive)
    if kw.get("exclusive"):
        assert int(got.sum(-1).max()) <= 1


def test_exclusive_takes_the_first_of_tied_attributes():
    """Two frames from one camera, one labeling everything attribute 0, the
    other attribute 1: every voted row ties and keeps attribute 0 in both
    packages."""
    params, alive = _scene(seed=4)
    arrs = _cameras()[0]
    a0 = np.zeros((H, W, M + 1), bool)
    a0[..., 0] = True
    a1 = np.zeros((H, W, M + 1), bool)
    a1[..., 1] = True
    got = clustering.cluster_gaussians(
        _tparams(params), torch.tensor(alive), {0: a0, 1: a1}, {0: torch_camera(arrs), 1: torch_camera(arrs)},
        exclusive=True,
    ).numpy()
    want = np.asarray(j_clustering.cluster_gaussians(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive), {0: jnp.asarray(a0), 1: jnp.asarray(a1)},
        {0: jax_camera(arrs), 1: jax_camera(arrs)}, backend="reference", exclusive=True,
    ))
    excluded = vote_boundary_rows(params, alive, arrs)
    _assert_equal_but_boundary(got, want, excluded, alive)
    assert got[:, 0].any() and not got[:, 1:].any()


def test_no_key_frame_gives_an_empty_mask():
    params, alive = _scene()
    got = clustering.cluster_gaussians(_tparams(params), torch.tensor(alive), {}, {})
    assert got.shape == (len(alive), 0) and got.dtype == torch.bool


def test_load_key_frames_matches_jax(tmp_path):
    path = "configs/key_frames.yaml"
    import yaml

    scenes = list(yaml.safe_load(open(path)))
    assert len(scenes) > 20
    for scene in scenes:
        assert load_key_frames(path, scene) == j_load_key_frames(path, scene)
    reg = tmp_path / "kf.yaml"
    reg.write_text("a: {frames: [3, 1]}\nb: {key_frames: [7]}\nc: {other: 1}\nd: [2, 5]\n")
    for scene, want in (("a", [3, 1]), ("b", [7]), ("c", []), ("d", [2, 5])):
        assert load_key_frames(reg, scene) == j_load_key_frames(reg, scene) == want
    with pytest.raises(KeyError):
        load_key_frames(reg, "missing")
    save_key_frames(tmp_path / "out.yaml", {"s": [4, 2]})
    assert load_key_frames(tmp_path / "out.yaml", "s") == [4, 2]


def test_export_cluster_ply_and_write_ply_points_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    n, m = 300, 12  # more attributes than the palette's 10 colors: it cycles
    means = rng.normal(size=(n, 3)).astype(np.float32)
    mask = rng.uniform(size=(n, m)) < 0.15
    alive = rng.uniform(size=n) < 0.8
    export_cluster_ply(tmp_path / "port.ply", torch.tensor(means), torch.tensor(mask), torch.tensor(alive))
    j_cluster_viz.export_cluster_ply(tmp_path / "jax.ply", means, mask, alive)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    xyz, rgb = read_ply_points(tmp_path / "port.ply")
    np.testing.assert_array_equal(xyz, means[alive])
    assert (rgb[~mask[alive].any(-1)] == 128).all()

    from freegaussian_tpu.data.ply import write_ply_points as j_write

    for colors in (None, rng.integers(0, 256, size=(n, 3)).astype(np.uint8)):
        write_ply_points(tmp_path / "a.ply", means, colors)
        j_write(tmp_path / "b.ply", means, colors)
        assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_save_and_load_gaussian_mask_round_trip(tmp_path):
    alive = torch.tensor(np.random.default_rng(0).uniform(size=40) < 0.7)
    mask = torch.tensor(np.random.default_rng(1).uniform(size=(40, 2)) < 0.4) & alive[:, None]
    clustering.save_gaussian_mask(tmp_path / "m.npy", mask, alive)
    assert np.load(tmp_path / "m.npy").shape == (int(alive.sum()), 2)
    assert torch.equal(clustering.load_gaussian_mask(tmp_path / "m.npy", 40, alive), mask)
