"""Brown-Conrady undistortion in PyTorch: the OpenCV calls the JAX package's
datamanager makes (freegaussian_tpu/data/datamanager.py:undistort_frame),
each computed as OpenCV computes it, so that the results are OpenCV's:

  - `undistort_points`            cv2.undistortPoints (its fixed 5-iteration
                                  solver, the bail-out when the radial factor
                                  turns negative)
  - `optimal_new_camera_matrix`   cv2.getOptimalNewCameraMatrix(alpha=0):
                                  the inner rectangle of a 9 x 9 grid of
                                  undistorted border points, and the valid
                                  ROI rounded from it
  - `undistort_map`               cv2.initUndistortRectifyMap's per-pixel
                                  source coordinates, in float64
  - `fixed_point_map` and        cv2.undistort of uint8 images: the map in
    `remap_bilinear_u8`           row stripes, quantized to 1/32 pixel, and a
                                  bilinear remap in 15-bit fixed point with a
                                  constant-0 border (one map for any number
                                  of channels)
  - `remap_nearest`               cv2.remap(INTER_NEAREST) on a float32 map

Distortion coefficients are in OpenCV's order (k1, k2, p1, p2, k3, k4, k5,
k6). Everything per pixel is float64 elementwise arithmetic in OpenCV's
order of operations, with no scalar divisions (PyTorch multiplies by the
reciprocal there on the GPU) and no fused products, so the CPU and the GPU
give the same bits. Checked against OpenCV 5.0 (tests/test_torch_undistort.py):
the matrix and the ROI equal, the images bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_BITS = 5  # cv::INTER_BITS: source coordinates in 1/32 pixel
_TAB = 1 << _BITS
_COEF_BITS = 15  # cv::INTER_REMAP_COEF_BITS: bilinear weights in 1/32768


def _coeffs(dist: Sequence[float]) -> list:
    k = [0.0] * 8
    k[: len(dist)] = [float(v) for v in dist]
    return k


def undistort_points(
    pts: torch.Tensor, K: np.ndarray, dist: Sequence[float], P: np.ndarray, iterations: int = 5
) -> torch.Tensor:
    """cv2.undistortPoints(pts, K, dist, P=P) for (N, 2) float64 pixel
    coordinates on any device: OpenCV's fixed-count iteration (its default
    criteria, 5 steps); a point whose radial factor turns negative keeps its
    distorted normalized coordinates (OpenCV's regression_14583 guard)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _coeffs(dist)
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    ifx, ify = 1.0 / fx, 1.0 / fy
    u, v = pts[:, 0], pts[:, 1]
    x0 = (u - cx) * ifx
    y0 = (v - cy) * ify
    x, y = x0, y0
    done = torch.zeros_like(x0, dtype=torch.bool)
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = (1 + ((k6 * r2 + k5) * r2 + k4) * r2) / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        bail = (icdist < 0) & ~done
        delta_x = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        delta_y = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        nx = (x0 - delta_x) * icdist
        ny = (y0 - delta_y) * icdist
        x = torch.where(done, x, torch.where(bail, x0, nx))
        y = torch.where(done, y, torch.where(bail, y0, ny))
        done = done | bail
    R = [[float(v) for v in row] for row in np.asarray(P, np.float64)]
    xx = R[0][0] * x + R[0][1] * y + R[0][2]
    yy = R[1][0] * x + R[1][1] * y + R[1][2]
    ww = 1.0 / (R[2][0] * x + R[2][1] * y + R[2][2])
    return torch.stack([xx * ww, yy * ww], dim=-1)


def optimal_new_camera_matrix(K: np.ndarray, dist: Sequence[float], size: Tuple[int, int]):
    """cv2.getOptimalNewCameraMatrix(K, dist, size, alpha=0) -> (new K
    (3, 3) float64, roi (x, y, w, h)): the camera that maps the inner
    rectangle of the undistorted 9 x 9 border grid onto the image, and the
    valid-pixel rectangle under it, rounded half to even and clipped to the
    image. Host work on 81 points."""
    width, height = size
    n = 9
    xs = [x * (width - 1) / (n - 1) for x in range(n)]
    ys = [y * (height - 1) / (n - 1) for y in range(n)]
    grid = torch.tensor([[x, y] for y in ys for x in xs], dtype=torch.float64)

    def inner(P):
        p = undistort_points(grid, K, dist, P).reshape(n, n, 2)
        flt_max = float(np.finfo(np.float32).max)
        x0 = max(-flt_max, float(p[:, 0, 0].max()))
        x1 = min(flt_max, float(p[:, -1, 0].min()))
        y0 = max(-flt_max, float(p[0, :, 1].max()))
        y1 = min(flt_max, float(p[-1, :, 1].min()))
        return x0, y0, x1 - x0, y1 - y0

    ix, iy, iw, ih = inner(np.eye(3))  # in normalized coordinates
    fx = (width - 1) / iw
    fy = (height - 1) / ih
    new_k = np.array([[fx, 0.0, -fx * ix], [0.0, fy, -fy * iy], [0.0, 0.0, 1.0]])
    rx, ry, rw, rh = (int(np.rint(v)) for v in inner(new_k))
    x0, y0 = max(rx, 0), max(ry, 0)
    w, h = min(rx + rw, width) - x0, min(ry + rh, height) - y0
    roi = (x0, y0, w, h) if w > 0 and h > 0 else (0, 0, 0, 0)
    return new_k, roi


def _inverse_camera(fx: float, fy: float, cx: float, cy: float) -> list:
    """The 3 x 3 inverse of [[fx, 0, cx], [0, fy, cy], [0, 0, 1]] as OpenCV's
    Matx33d::inv computes it (cofactors times one over the determinant),
    row-major."""
    det = fx * (fy * 1.0 - 0.0 * cy) - 0.0 * (0.0 * 1.0 - 0.0 * cy) + cx * (0.0 * 0.0 - 0.0 * fy)
    d = 1.0 / det
    return [
        (fy * 1.0 - cy * 0.0) * d, (cx * 0.0 - 0.0 * 1.0) * d, (0.0 * cy - cx * fy) * d,
        (cy * 0.0 - 0.0 * 1.0) * d, (fx * 1.0 - cx * 0.0) * d, (cx * 0.0 - fx * cy) * d,
        (0.0 * 0.0 - fy * 0.0) * d, (0.0 * 0.0 - fx * 0.0) * d, (fx * fy - 0.0 * 0.0) * d,
    ]


def undistort_map(
    K: np.ndarray, dist: Sequence[float], new_k: np.ndarray, size: Tuple[int, int], device, stripe: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) float64 source coordinates (u, v) of every output pixel, as
    cv2.initUndistortRectifyMap(K, dist, None, new_k, size) computes them.
    With `stripe` > 0 the rows go in stripes of that many, each with its own
    inverse camera (new_k's cy less the stripe's first row, which moves only
    the inverse's [1, 2] entry), as cv2.undistort builds its map."""
    width, height = size
    k1, k2, p1, p2, k3, k4, k5, k6 = _coeffs(dist)
    fx, fy, u0, v0 = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    nfx, nfy, ncx, ncy = (float(new_k[0, 0]), float(new_k[1, 1]), float(new_k[0, 2]), float(new_k[1, 2]))
    stripe = stripe or height
    rows = np.arange(height)
    first = rows // stripe * stripe
    irs = {y0: _inverse_camera(nfx, nfy, ncx, ncy - y0) for y0 in np.unique(first).tolist()}
    ir = irs[0]
    col = lambda v: torch.tensor(v, dtype=torch.float64, device=device)[:, None]
    i = col((rows - first).astype(np.float64))
    ir5 = col([irs[y0][5] for y0 in first.tolist()])
    j = torch.arange(width, dtype=torch.float64, device=device)[None, :]
    _x = i * ir[1] + ir[2] + j * ir[0]
    _y = i * ir[4] + ir5 + j * ir[3]
    _w = i * ir[7] + ir[8] + j * ir[6]
    w = 1.0 / _w
    x = _x * w
    y = _y * w
    x2 = x * x
    y2 = y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    return u, v


def _gather_zero(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """img[yy, xx] with 0 where (yy, xx) is outside the image."""
    h, w = img.shape[:2]
    ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
    v = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
    return torch.where(ok.reshape(*ok.shape, *([1] * (img.dim() - 2))), v, torch.zeros((), dtype=v.dtype, device=v.device))


def fixed_point_map(K: np.ndarray, dist: Sequence[float], new_k: np.ndarray, size: Tuple[int, int], device):
    """cv2.undistort's map for an image of `size` (W, H): the source
    coordinates in stripes of max(1, 4096 // W) rows, rounded half to even
    to 1/32 pixel (cv2's CV_16SC2 + CV_16UC1 maps) -> (x, y, x fraction,
    y fraction), int64 (H, W), the fractions in 1/32."""
    width, height = size
    u, v = undistort_map(K, dist, new_k, size, device, stripe=min(max(1, 4096 // max(width, 1)), height))
    lim = float(2**31 - 1)
    iu = torch.round(u * _TAB).clamp(-lim - 1, lim).long()
    iv = torch.round(v * _TAB).clamp(-lim - 1, lim).long()
    return iu >> _BITS, iv >> _BITS, iu & (_TAB - 1), iv & (_TAB - 1)


def remap_bilinear_u8(img: torch.Tensor, fixed_map) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of an (H, W) or (H, W, C)
    uint8 image through a `fixed_point_map`: cv2's fixed-point weights
    ((32 - a)(32 - b) x 32, ..., summing to 2^15) and rounding, the pixels
    outside the source 0."""
    sx, sy, ax, ay = fixed_map
    src = img.to(torch.int64)
    acc = torch.zeros((*sx.shape, *img.shape[2:]), dtype=torch.int64, device=img.device)
    for dy, wy in ((0, _TAB - ay), (1, ay)):
        for dx, wx in ((0, _TAB - ax), (1, ax)):
            weight = wy * wx * (1 << (_COEF_BITS - 2 * _BITS))
            acc += _gather_zero(src, sy + dy, sx + dx) * (weight[..., None] if img.dim() == 3 else weight)
    return ((acc + (1 << (_COEF_BITS - 1))) >> _COEF_BITS).to(torch.uint8)


def remap_nearest(src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """cv2.remap(src, map_x, map_y, INTER_NEAREST) with float32 maps: each
    source coordinate rounded half to even, 0 outside the source."""
    return _gather_zero(src, torch.round(map_y).long(), torch.round(map_x).long())
