"""The port's undistortion (`data/undistort.py`, `datamanager.undistort_frame`)
against the JAX package's, which calls OpenCV (5.0 here), on seeded frames:
mild and strong barrel, pincushion, and tangential distortion with an
off-centre principal point.

Budgets: the camera matrix and the ROI equal OpenCV's exactly; so do the
undistorted image (cv2's 1/32-pixel map and 15-bit bilinear weights are
modelled), the thresholded masks (0 flipped pixels), the nearest-remapped
depth and the flow (float64 undistortPoints in OpenCV's order of
operations). Each building block is also held against its OpenCV call on its
own. Without distortion the frame comes back unchanged, bit for bit; the
alignment property of tests/test_data.py holds for the port."""

import cv2
import numpy as np
import pytest
import torch

from freegaussian_tpu.data.datamanager import undistort_frame as j_undistort
from freegaussian_tpu_torch.data import undistort as ud
from freegaussian_tpu_torch.data.datamanager import undistort_frame as t_undistort

# (k1, k2, k3, k4, p1, p2), as the dataparser's `distortion` rows
CASES = {
    "mild_barrel": (-0.05, 0.01, 0.0, 0.0, 0.0, 0.0),
    "strong_barrel": (-0.3, 0.08, -0.01, 0.0, 0.0, 0.0),
    "pincushion": (0.12, 0.02, 0.0, 0.0, 0.0, 0.0),
    "tangential": (-0.1, 0.02, 0.003, 0.0, 0.006, -0.004),
}


def _frame(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    img[h // 4 : h // 2, w // 5 : w // 2] = 255  # edges for the masks to follow
    mask = img[..., 0] > 127
    depth = rng.uniform(1.0, 6.0, size=(h, w, 1)).astype(np.float32)
    flow = (rng.normal(size=(h, w, 2)) * 4).astype(np.float32)
    atrb = np.stack([mask, ~mask, rng.uniform(size=(h, w)) < 0.3], axis=-1)
    K = np.array([[0.8 * w, 0, w / 2 + 1.7], [0, 0.82 * w, h / 2 - 1.1], [0, 0, 1]], np.float32)
    return K, img, mask, depth, flow, atrb


@pytest.mark.parametrize("case", sorted(CASES))
def test_undistort_frame_matches_jax(case):
    h, w = 60, 84
    K, img, mask, depth, flow, atrb = _frame(sorted(CASES).index(case), h, w)
    dist = np.array(CASES[case], np.float32)
    want = j_undistort(K, dist, img, mask=mask, depth=depth, flow=flow, atrb_mask=atrb)
    got = t_undistort(K, dist, img, mask=mask, depth=depth, flow=flow, atrb_mask=atrb, device="cpu")
    for name, a, b in zip(("K", "image", "mask", "depth", "flow", "atrb_mask"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[1].shape[:2] != (h, w)  # cropped to the ROI


@pytest.mark.parametrize("case", sorted(CASES))
def test_building_blocks_match_opencv(case):
    """optimal_new_camera_matrix, fixed_point_map + remap_bilinear_u8 (3 channels and 1),
    undistort_map + remap_nearest and undistort_points against their cv2
    calls, at an odd size whose row stripes do not divide the height."""
    h, w = 47, 101
    K, img, mask, depth, _, _ = _frame(7 + sorted(CASES).index(case), h, w)
    K = K.astype(np.float64)
    d = CASES[case]
    dist = [d[0], d[1], d[4], d[5], d[2], d[3], 0.0, 0.0]
    new_k, roi = cv2.getOptimalNewCameraMatrix(K, np.array(dist), (w, h), 0)
    got_k, got_roi = ud.optimal_new_camera_matrix(K, dist, (w, h))
    np.testing.assert_array_equal(got_k, new_k)
    assert got_roi == tuple(roi)
    for src in (img, mask.astype(np.uint8) * 255):
        fixed = ud.fixed_point_map(K, dist, new_k, (w, h), "cpu")
        np.testing.assert_array_equal(ud.remap_bilinear_u8(torch.from_numpy(src), fixed).numpy(),
                                      cv2.undistort(src, K, np.array(dist), None, new_k))
    mx, my = cv2.initUndistortRectifyMap(K, np.array(dist), None, new_k, (w, h), cv2.CV_32FC1)
    u, v = ud.undistort_map(K, dist, new_k, (w, h), "cpu")
    np.testing.assert_array_equal(u.float().numpy(), mx)
    np.testing.assert_array_equal(v.float().numpy(), my)
    np.testing.assert_array_equal(ud.remap_nearest(torch.from_numpy(depth[..., 0]), u.float(), v.float()).numpy(),
                                  cv2.remap(depth[..., 0], mx, my, cv2.INTER_NEAREST))
    pts = np.random.default_rng(3).uniform(-20, w + 20, size=(500, 2))
    np.testing.assert_array_equal(ud.undistort_points(torch.from_numpy(pts), K, dist, new_k).numpy(),
                                  cv2.undistortPoints(pts[:, None], K, np.array(dist), P=new_k).reshape(-1, 2))


def test_no_distortion_is_the_identity():
    K, img, mask, depth, flow, atrb = _frame(11, 30, 40)
    dist = np.zeros(6, np.float32)
    got = t_undistort(K, dist, img, mask=mask, depth=depth, flow=flow, atrb_mask=atrb, device="cpu")
    want = j_undistort(K, dist, img, mask=mask, depth=depth, flow=flow, atrb_mask=atrb)
    for a, b, c in zip(got, want, (K, img, mask, depth, flow, atrb)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="k4"):
        t_undistort(K, np.array([0.1, 0, 0, 0.01, 0, 0], np.float32), img, device="cpu")


def test_undistorted_masks_stay_aligned_with_image():
    """tests/test_data.py:345-370 on the port: a mask derived from the image
    content still matches that content after the joint undistortion, and
    the raw (distorted) mask does not."""
    h, w = 48, 64
    img = np.zeros((h, w, 3), np.uint8)
    img[8:32, 10:40] = 255
    mask = img[..., 0] > 127
    atrb = np.stack([mask, ~mask], axis=-1)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    dist = np.array([-0.25, 0.05, 0, 0, 0, 0], np.float32)
    _, img2, mask2, _, _, atrb2 = t_undistort(K, dist, img, mask=mask, atrb_mask=atrb, device="cpu")
    img_mask2 = img2[..., 0] > 127
    mismatch = (mask2 != img_mask2).mean()
    assert mismatch < 0.02
    assert (atrb2[..., 0] != img_mask2).mean() < 0.02
    hh, ww = img_mask2.shape
    assert (mask[:hh, :ww] != img_mask2).mean() > mismatch


def test_undistort_frame_runs_on_cuda_unless_told(monkeypatch):
    """Like the port's entry points, it defaults to the card and refuses it
    without one: no silent CPU run."""
    K, img, *_ = _frame(12, 30, 40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_undistort(K, np.array([0.1, 0.01, 0, 0, 0.001, 0], np.float32), img)
