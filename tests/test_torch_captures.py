"""The port's real-capture front end against the JAX package's, on seeded
captures (tests/torch_port_helpers.py): `parse_real` (per-frame and meta
intrinsics, `images_2`, articulation and foreground masks, split x
interval, the colmap .bin / .txt conversion) and `parse_conerf` (each
annotation route with values.yaml and scene.json) give the same
ParsedDataset field for field; each `conerf_annotations` function gives the
JAX package's arrays, and `rasterize_polygons` cv2.fillPoly's pixels (bit
for bit, OpenCV 5.0) on seeded convex, non-convex, self-intersecting and
border-crossing polygons; `read_image` gives `imageio.v2.imread`'s pixels.
Everything here is exact: the same numpy arithmetic on both sides, and the
port's polygon fill in exact rational arithmetic."""

import json
import shutil

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import yaml
from PIL import Image

from freegaussian_tpu.data import conerf_annotations as j_ann
from freegaussian_tpu.data import dataparsers as j_parsers
from freegaussian_tpu.data import ply as j_ply
from freegaussian_tpu_torch.data import conerf_annotations as t_ann
from freegaussian_tpu_torch.data import dataparsers as t_parsers
from freegaussian_tpu_torch.data import ply as t_ply
from freegaussian_tpu_torch.data.images import image_size, read_image
from test_torch_data import _assert_parsed_equal
from torch_port_helpers import make_conerf_capture, make_real_capture

REAL_CASES = {
    "meta_intrinsics": dict(make=dict(per_frame=False), parse=dict()),
    "per_frame_intrinsics": dict(make=dict(per_frame=True), parse=dict(interval=1)),
    "images_2": dict(make=dict(downscale=2), parse=dict(downscale_factor=2)),
    "val_split_interval_3": dict(make=dict(), parse=dict(interval=3, train_split_fraction=0.6), split="val"),
    "no_masks_no_points": dict(make=dict(num_attributes=0, fg_masks=False, points=None), parse=dict(auto_scale=False)),
    "filename_times_fallback": dict(make=dict(), parse=dict(load_mask=False, load_flow=False), rename=True),
}


@pytest.mark.parametrize("case", sorted(REAL_CASES))
def test_parse_real_matches_jax(tmp_path, case):
    spec = REAL_CASES[case]
    root = make_real_capture(tmp_path / "cap", n=7, seed=len(case), **spec["make"])
    if spec.get("rename"):  # non-numeric file suffixes: times from linspace
        meta = json.loads((root / "transforms.json").read_text())
        for i, f in enumerate(meta["frames"]):
            new = f"images/shot_{'abcdefg'[i]}.jpg"
            (root / f["file_path"]).rename(root / new)
            f["file_path"] = new
        (root / "transforms.json").write_text(json.dumps(meta))
    split = spec.get("split", "train")
    t = t_parsers.parse_real(root, split, **spec["parse"])
    j = j_parsers.parse_real(root, split, **spec["parse"])
    _assert_parsed_equal(t, j)
    assert t.distortion.shape == (len(t), 6) and np.any(t.distortion)
    if spec["make"].get("num_attributes", 2) and spec["parse"].get("load_mask", True):
        assert t.atrb_masks is not None and t.mask_filenames is not None


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_parse_real_converts_colmap_points_as_jax(tmp_path, fmt):
    """Without sparse_pc.ply the parser converts colmap/sparse/0/points3D.*
    once (applied_transform first): the port's PLY bytes equal the JAX
    package's, and the seed points agree."""
    make_real_capture(tmp_path / "a", n=4, points=fmt)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    t = t_parsers.parse_real(tmp_path / "a", "train")
    j_parsers.parse_real(tmp_path / "b", "train")
    assert (tmp_path / "a/sparse_pc.ply").read_bytes() == (tmp_path / "b/sparse_pc.ply").read_bytes()
    _assert_parsed_equal(t, j_parsers.parse_real(tmp_path / "a", "train"))
    assert t.seed_points is not None
    sparse = tmp_path / "a/colmap/sparse/0"
    for a, b in zip(t_ply.read_colmap_points3d(sparse), j_ply.read_colmap_points3d(sparse)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        t_ply.read_colmap_points3d(tmp_path)


@pytest.mark.parametrize("route", ["polygons", "coco", "blender"])
@pytest.mark.parametrize("split,interval", [("train", 1), ("val", 2)])
def test_parse_conerf_matches_jax(tmp_path, route, split, interval):
    root = make_conerf_capture(tmp_path / "cap", n=6, route=route, seed=3)
    t = t_parsers.parse_conerf(root, split, interval=interval, downscale=2)
    j = j_parsers.parse_conerf(root, split, interval=interval, downscale=2)
    _assert_parsed_equal(t, j)
    assert t.scene_box is not None and t.atrb_values is not None and t.seed_points is not None
    if split == "train":
        assert t.atrb_masks is not None and t.atrb_masks[..., 1:].any()


def test_parse_conerf_without_scene_or_annotations_matches_jax(tmp_path):
    root = make_conerf_capture(tmp_path / "cap", n=4, route=None, values=False, bbox=False, points=False)
    (root / "scene.json").unlink()
    _assert_parsed_equal(t_parsers.parse_conerf(root, "train"), j_parsers.parse_conerf(root, "train"))
    assert t_parsers.PARSERS.keys() == j_parsers.PARSERS.keys()


def _polygons(rng, kind, h, w, k):
    if kind == "convex":
        ang, r = np.sort(rng.uniform(0, 2 * np.pi, k)), rng.uniform(2, 0.6 * max(h, w))
    elif kind == "nonconvex":
        ang, r = np.sort(rng.uniform(0, 2 * np.pi, k)), rng.uniform(1, 0.6 * max(h, w), k)
    if kind in ("convex", "nonconvex"):
        c = rng.uniform([0, 0], [w, h])
        return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1)
    if kind == "self_intersecting":
        return rng.uniform([0, 0], [w, h], size=(k, 2))
    return rng.uniform([-w, -h], [2 * w, 2 * h], size=(k, 2))  # crossing the border


@pytest.mark.parametrize("kind", ["convex", "nonconvex", "self_intersecting", "border_crossing"])
def test_rasterize_polygons_matches_fillpoly(kind):
    """Bit for bit against cv2.fillPoly (the JAX package's fill) on 150
    seeded polygons of each kind, 3-14 vertices, images up to 90 x 90."""
    rng = np.random.default_rng(["convex", "nonconvex", "self_intersecting", "border_crossing"].index(kind))
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(4, 90, size=2))
        verts = np.round(_polygons(rng, kind, h, w, int(rng.integers(3, 15)))).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [verts.reshape(-1, 1, 2)], 1)
        got = np.zeros((h, w), np.uint8)
        t_ann.fill_polygon(got, verts)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {h}x{w} {verts.tolist()}")
    polys = [(a % 2, _polygons(rng, kind, 40, 50, 7) + 0.37) for a in range(4)]
    np.testing.assert_array_equal(t_ann.rasterize_polygons(polys, 40, 50, 2), j_ann.rasterize_polygons(polys, 40, 50, 2))


def test_conerf_annotation_loaders_match_jax(tmp_path):
    """load_conerf_annotation (each layout), load_coco_annotations,
    coco_num_attributes, load_conerf_values, discover_num_attributes,
    load_blender_annotations and load_conerf_values_yaml give the JAX
    package's values on the same files."""
    for route in ("polygons", "coco", "blender"):
        root = make_conerf_capture(tmp_path / route, n=6, route=route, seed=5)
        assert t_ann.discover_num_attributes(root) == j_ann.discover_num_attributes(root)
    ann = tmp_path / "polygons/annotations"
    for path in sorted(ann.glob("*.json")) + [ann / "missing.json"]:
        a, b = (m.load_conerf_annotation(path, 24, 32, 2, downscale=2) for m in (t_ann, j_ann))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    coco = tmp_path / "coco/annotations.coco.json"
    assert t_ann.coco_num_attributes(coco) == j_ann.coco_num_attributes(coco) == 2
    a, b = t_ann.load_coco_annotations(coco, 24, 32, 2, 2), j_ann.load_coco_annotations(coco, 24, 32, 2, 2)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    no_cats = tmp_path / "no_cats.json"
    no_cats.write_text(json.dumps({"annotations": [{"image_id": 1, "category_id": 3}]}))
    assert t_ann.coco_num_attributes(no_cats) == j_ann.coco_num_attributes(no_cats) == 3
    values = tmp_path / "blender/annotations/values.json"
    a, b = t_ann.load_conerf_values(values), j_ann.load_conerf_values(values)
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    fids = [f"{i:06d}" for i in range(6)]
    for m in (0, 2):
        for x, y in zip(t_ann.load_blender_annotations(tmp_path / "blender/annotations", fids, 24, 32, m),
                        j_ann.load_blender_annotations(tmp_path / "blender/annotations", fids, 24, 32, m)):
            np.testing.assert_array_equal(x, y)
    vy = tmp_path / "polygons/values.yaml"
    assert yaml.safe_load(vy.read_text())
    for x, y in zip(t_ann.load_conerf_values_yaml(vy, [int(f) for f in fids], 2),
                    j_ann.load_conerf_values_yaml(vy, [int(f) for f in fids], 2)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["jpeg_rgb", "jpeg_gray", "png_rgb", "png_palette"])
def test_read_image_matches_imageio(tmp_path, kind):
    """read_image gives imageio.v2.imread's pixels (JPEG through Pillow, PNG
    through the port's decoder), and image_size the header's size."""
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, size=(37, 53, 3)).astype(np.uint8)
    im = Image.fromarray(rgb[..., 0] if kind == "jpeg_gray" else rgb)
    if kind == "png_palette":
        im = im.convert("P")
    path = tmp_path / ("f.jpg" if kind.startswith("jpeg") else "f.png")
    im.save(path)
    want = imageio.imread(path)
    got = read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert image_size(path) == want.shape[:2]
