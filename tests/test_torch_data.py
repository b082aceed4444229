"""The port's data layer and config loader against the JAX package's, on the
same files: the dataparsers (every ParsedDataset field), the PLY reader, the
PNG decoder (against imageio), the datamanager (frame order and batches,
and the undistorted batches of a distorted real capture), the flow resize (against cv2.resize(INTER_NEAREST)) and the YAML overlay
(against yaml.safe_load and the JAX resolver over every file in configs/).
Everything here is exact: the same numpy arithmetic on both sides."""

import dataclasses
import json
import zlib
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import yaml

from freegaussian_tpu.data import dataparsers as j_parsers
from freegaussian_tpu.data.datamanager import FullImageDatamanager as JDatamanager
from freegaussian_tpu.data.datamanager import load_flow_npy as j_load_flow
from freegaussian_tpu.data.ply import read_ply_points as j_read_ply
from freegaussian_tpu.data.ply import write_ply_points
from freegaussian_tpu.engine import config as j_config
from freegaussian_tpu_torch.data import dataparsers as t_parsers
from freegaussian_tpu_torch.data.datamanager import FullImageDatamanager as TDatamanager
from freegaussian_tpu_torch.data.datamanager import load_flow_npy as t_load_flow
from freegaussian_tpu_torch.data.datamanager import nearest_resize
from freegaussian_tpu_torch.data.ply import read_ply_points as t_read_ply
from freegaussian_tpu_torch.engine import config as t_config
from freegaussian_tpu_torch.viewer.png import _SIGNATURE, _chunk, decode_png
from test_data import _write_png, make_synthetic_dataset
from torch_port_helpers import make_real_capture

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "configs").rglob("*.yaml"))


def _assert_parsed_equal(t, j):
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if b is None or isinstance(b, (int, float, str)):
            assert a == b, f.name
        elif isinstance(b, list):
            assert [str(x) for x in a] == [str(x) for x in b], f.name
        elif isinstance(b, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("interval", [1, 2])
def test_parse_synthetic_matches_jax(tmp_path, split, interval):
    make_synthetic_dataset(tmp_path, n=12, h=24, w=32)
    kw = dict(interval=interval, train_split_fraction=0.8)
    _assert_parsed_equal(t_parsers.parse_synthetic(tmp_path, split, **kw), j_parsers.parse_synthetic(tmp_path, split, **kw))


def _make_dnerf(root: Path, n=5):
    frames = []
    for i in range(n):
        _write_png(root / f"train/r_{i:03d}.png", h=20, w=28, seed=i)
        c2w = np.eye(4)
        c2w[:3, 3] = [0.3 * i, -0.2, 3.0]
        frames.append({"file_path": f"./train/r_{i:03d}", "transform_matrix": c2w.tolist(), "time": i / (n - 1)})
    (root / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    rng = np.random.default_rng(3)
    write_ply_points(root / "points.ply", rng.normal(size=(40, 3)), rng.integers(0, 256, size=(40, 3)))


@pytest.mark.parametrize("with_ply", [False, True])
def test_parse_dnerf_matches_jax(tmp_path, with_ply):
    _make_dnerf(tmp_path)
    kw = dict(interval=2, ply_path=tmp_path / "points.ply" if with_ply else None)
    t, j = t_parsers.parse_dnerf(tmp_path, "train", **kw), j_parsers.parse_dnerf(tmp_path, "train", **kw)
    _assert_parsed_equal(t, j)
    assert (t.seed_points is not None) == with_ply


def test_pose_utilities_match_jax():
    rng = np.random.default_rng(4)
    poses = rng.normal(size=(7, 3, 4)).astype(np.float32)
    for method in ("up", "none"):
        for a, b in zip(t_parsers.auto_orient_and_center_poses(poses, method), j_parsers.auto_orient_and_center_poses(poses, method)):
            np.testing.assert_array_equal(a, b)
    assert t_parsers.auto_scale_poses(poses) == j_parsers.auto_scale_poses(poses)
    for n, frac in ((10, 0.9), (7, 0.5), (3, 1.0)):
        for a, b in zip(t_parsers.train_eval_split_fraction(n, frac), j_parsers.train_eval_split_fraction(n, frac)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_parsers._prev_ids(9, 2), j_parsers._prev_ids(9, 2))
    np.testing.assert_array_equal(
        t_parsers.rotation_matrix_between(np.array([0, 1.0, 0]), np.array([0, 0, 1.0])),
        j_parsers.rotation_matrix_between(np.array([0, 1.0, 0]), np.array([0, 0, 1.0])),
    )
    assert set(t_parsers.PARSERS) == set(j_parsers.PARSERS)
    assert {k: f.__name__ for k, f in t_parsers.PARSERS.items()} == {k: f.__name__ for k, f in j_parsers.PARSERS.items()}


@pytest.mark.parametrize("fmt", ["binary", "ascii"])
@pytest.mark.parametrize("rgb", [False, True])
def test_read_ply_points_matches_jax(tmp_path, fmt, rgb):
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(30, 3)).astype(np.float32)
    col = rng.integers(0, 256, size=(30, 3)).astype(np.uint8) if rgb else None
    path = tmp_path / "p.ply"
    if fmt == "binary":
        write_ply_points(path, xyz, col)
    else:
        props = ["property float x", "property float y", "property float z"]
        props += ["property uchar red", "property uchar green", "property uchar blue"] if rgb else []
        rows = [" ".join([f"{v:.6f}" for v in p] + ([str(int(c)) for c in col[i]] if rgb else [])) for i, p in enumerate(xyz)]
        path.write_text("\n".join(["ply", "format ascii 1.0", "element vertex 30", *props, "end_header", *rows]) + "\n")
    (ta, tb), (ja, jb) = t_read_ply(path), j_read_ply(path)
    np.testing.assert_array_equal(ta, ja)
    assert (tb is None) == (jb is None) == (not rgb)
    if rgb:
        np.testing.assert_array_equal(tb, jb)


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """PNG bytes of an 8-bit image with row y filtered by filters[y % len]."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        out.append(np.concatenate([[kind], (cur - pred) % 256]).astype(np.uint8))
        prior = cur
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, ctype, 0, 0, 0])
    return _SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes())) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray+alpha", "rgb", "rgba"])
def test_decode_png_matches_imageio(channels):
    """Every filter type on its own, and all five mixed row by row."""
    rng = np.random.default_rng(channels)
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    ramp = (np.arange(13)[:, None] * 7 + np.arange(17)[None, :] * 11).reshape(13, 17, *([1] if channels > 1 else []))
    img = ((ramp + rng.integers(0, 40, size=shape)) % 256).astype(np.uint8)  # wraps: every branch of Paeth
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        data = _filtered_png(img, filters)
        got = decode_png(data)
        want = imageio.imread(data)
        assert got.dtype == want.dtype and got.shape == want.shape, (filters, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=str(filters))
        np.testing.assert_array_equal(got, img)


def test_decode_png_refuses_what_it_cannot_read():
    img = np.zeros((4, 4, 3), np.uint8)
    data = _filtered_png(img, [0])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + data[6:])
    bad_depth = data.replace(bytes([8, 2, 0, 0, 0]), bytes([16, 2, 0, 0, 0]), 1)
    ihdr_at = data.index(b"IHDR")
    fixed = bad_depth[: ihdr_at + 17] + np.array([zlib.crc32(bad_depth[ihdr_at : ihdr_at + 17])], ">u4").tobytes() + bad_depth[ihdr_at + 21 :]
    with pytest.raises(ValueError, match="8-bit"):
        decode_png(fixed)
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bad_depth)
    bad_filter = _SIGNATURE + _chunk(b"IHDR", data[ihdr_at + 4 : ihdr_at + 17]) + _chunk(
        b"IDAT", zlib.compress(bytes([7] + [0] * 12) * 4)
    ) + _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="filter type 7"):
        decode_png(bad_filter)


def test_datamanager_matches_jax(tmp_path):
    """The same frame order over three epochs (one seed, one permutation
    sequence), and every batch tensor and camera field equal."""
    make_synthetic_dataset(tmp_path, n=7, h=24, w=32)
    parsed_j = j_parsers.parse_synthetic(tmp_path, "train", interval=2)
    parsed_t = t_parsers.parse_synthetic(tmp_path, "train", interval=2)
    jdm = JDatamanager(parsed_j, seed=11)
    tdm = TDatamanager(parsed_t, seed=11, device="cpu")
    assert len(tdm) == len(jdm)
    assert tdm.draw_indices(3 * len(tdm)) == jdm.draw_indices(3 * len(jdm))
    for step in range(len(tdm) + 2):
        ti, tcam, tb = tdm.next_train_indexed(step)
        ji, jcam, jb = jdm.next_train_indexed(step)
        assert ti == ji
        assert sorted(tb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
        for cam_t, cam_j in ((tcam, jcam), (tdm.camera0(ti), jdm.camera0(ji))):
            for f in ("c2w", "fx", "fy", "cx", "cy", "time"):
                np.testing.assert_array_equal(getattr(cam_t, f).numpy(), np.asarray(getattr(cam_j, f)), err_msg=f)
            assert (cam_t.width, cam_t.height) == (cam_j.width, cam_j.height)
    # batches are fresh dicts: a caller's added keys do not reach the cache
    _, b = tdm.get_batch(0)
    b["flow_valid"] = torch.tensor(1.0)
    assert "flow_valid" not in tdm.get_batch(0)[1]
    assert [c.time.item() for c, _ in tdm.eval_frames()] == [float(c.time) for c, _ in jdm.eval_frames()]


def test_datamanager_undistorts_like_jax(tmp_path):
    """A distorted real capture (JPEG frames, per-frame intrinsics and
    distortion, foreground and articulation masks, flow): every frame's
    camera and every batch tensor equal the JAX package's (OpenCV's
    undistortion), and each frame is cropped to its valid rectangle."""
    root = make_real_capture(tmp_path, n=5, h=30, w=40, distortion=(-0.2, 0.04, 0.0, 0.0, 0.004, -0.003))
    for d in ("flow_n2",):
        (root / d).mkdir()
        for i in range(5):
            np.save(root / d / f"frame_{i:05d}.npy", np.random.default_rng(i).normal(size=(30, 40, 2)).astype(np.float32))
    parsed_t, parsed_j = t_parsers.parse_real(root, "train"), j_parsers.parse_real(root, "train")
    tdm, jdm = TDatamanager(parsed_t, seed=3, device="cpu"), JDatamanager(parsed_j, seed=3)
    for i in range(len(tdm)):
        (tcam, tb), (jcam, jb) = tdm.get_batch(i), jdm.get_batch(i)
        assert sorted(tb) == sorted(jb) == ["atrb_mask", "flow", "image", "mask", "mask_valid"]
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
        for f in ("c2w", "fx", "fy", "cx", "cy", "time"):
            np.testing.assert_array_equal(getattr(tcam, f).numpy(), np.asarray(getattr(jcam, f)), err_msg=f)
        assert (tcam.width, tcam.height) == (jcam.width, jcam.height) and tcam.width < 40
        np.testing.assert_array_equal(tdm.camera0(i).cx.numpy(), np.asarray(jdm.camera0(i).cx))


@pytest.mark.parametrize("src,dst", [((24, 32), (12, 16)), ((24, 32), (48, 64)), ((17, 23), (30, 11)), ((100, 100), (37, 73))])
def test_flow_resize_matches_cv2(tmp_path, src, dst):
    flow = np.random.default_rng(src[0]).normal(size=(*src, 2)).astype(np.float32)
    np.testing.assert_array_equal(nearest_resize(flow, *dst), cv2.resize(flow, dst[::-1], interpolation=cv2.INTER_NEAREST))
    np.save(tmp_path / "f.npy", flow)
    np.testing.assert_array_equal(t_load_flow(tmp_path / "f.npy", *dst, 0.5), j_load_flow(tmp_path / "f.npy", *dst, 0.5))


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_pyyaml(path):
    """Every file in configs/: the port's reader gives what yaml.safe_load
    gives, and the overlay (with the resolver) what the JAX package's does;
    the trainer configs built from it agree field by field."""
    full = REPO / path
    assert t_config.load_yaml(full) == (yaml.safe_load(full.read_text()) or {})
    assert t_config.load_yaml_overlay(full) == j_config.load_yaml_overlay(full)
    if "pipeline" not in t_config.load_yaml(full) and "dataparser" not in t_config.load_yaml(full):
        return  # not a trainer config (key_frames.yaml)
    base = full.parent / "base.yaml"
    args = (base, full) if base.exists() and base != full else (full,)
    t_cfg, j_cfg = t_config.trainer_config_from_yaml(*args), j_config.trainer_config_from_yaml(*args)
    for f in dataclasses.fields(t_cfg):
        a, b = getattr(t_cfg, f.name), getattr(j_cfg, f.name)
        if dataclasses.is_dataclass(a):
            # deform_impl's default differs by design (the port's kernels vs the JAX package's flax path)
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            a.pop("deform_impl", None)
            b.pop("deform_impl", None)
        assert a == b, f.name


def test_yaml_reader_resolves_and_refuses():
    """The resolver gives what the JAX package's gives, and refuses an
    `${eval:}` expression that is not arithmetic."""
    text = "a: 1\nb:\n  c: 1.0e-4  # comment\n  d: 1e-4\n  e: ${eval:2 * 3 + 1}\nf: [1, x, 2.5]\ng:\nh: on\n"
    tree = yaml.safe_load(text)
    assert t_config.resolve_tree(tree) == j_config.resolve_tree(tree)
    assert t_config.resolve_tree(tree)["b"]["e"] == 7
    with pytest.raises(ValueError, match="unsafe eval"):
        t_config.resolve_tree({"a": "${eval:__import__('os')}"})
