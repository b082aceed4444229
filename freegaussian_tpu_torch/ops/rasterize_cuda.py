"""The tile compositor: CUDA kernel wrapper and its plain PyTorch version.

`rasterize_tiles` takes the binned intersections of `ops/tiles.py` and
composites every tile front to back. On a CUDA tensor it launches the kernel
of `csrc/rasterize_fwd.cu` (the port of the TPU kernel
`freegaussian_tpu/ops/rasterize_pallas.py:_fwd_kernel`) or raises; on a CPU
tensor it runs `rasterize_tiles_plain`, which computes the same function
with padded (tiles, pixels, K) tensors. `rasterize_pixels` is the pixel
stage end to end (binning, then compositing), the twin of
`rasterize_pixels_pallas`'s forward.
"""

from __future__ import annotations

import ctypes

import torch

from .rasterize_ref import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_EPS
from .tiles import build_intersections

# Bbox granularity of the compositing contract (gsplat isect_tiles): at a
# kernel tile size other than this, the compositor gates each pair by the
# Gaussian's 16-px tile bbox so outputs do not depend on the tile size.
CONTRACT_TILE = 16
MAX_CHANNELS = 8
TILE_SIZES = (16, 32)
# Most (tile, pixel, intersection) elements in one padded batch of the plain version
PLAIN_BATCH_ELEMENTS = 1 << 24

# Kernel launches by kernel name. Each wrapper adds one where it launches its
# kernel and nowhere else; `chip_smoke.py` zeroes and reads it.
LAUNCHES = {"rasterize_fwd": 0}
# The CUDA sources (csrc/<name>.cu) this module launches.
KERNEL_SOURCES = ("rasterize_fwd",)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ..cuda_build import load

        lib = load("rasterize_fwd")
        fn = lib.rasterize_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        lib.rasterize_fwd_error_string.argtypes = [ctypes.c_int]
        lib.rasterize_fwd_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.rasterize_fwd_error_string)
    return _fn


def _check(name, t, dtype, device, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def rasterize_tiles(
    means2d: torch.Tensor,  # (N, 2) f32
    conics: torch.Tensor,  # (N, 3) f32
    colors: torch.Tensor,  # (N, C) f32, C <= 8
    opacities: torch.Tensor,  # (N,) f32
    radii: torch.Tensor,  # (N,) f32 bbox radius (used by the contract gate)
    gauss_ids: torch.Tensor,  # (I,) int32, (tile, depth)-sorted
    tile_offsets: torch.Tensor,  # (T + 1,) int32
    width: int,
    height: int,
    tile_size: int,
):
    """Composite every tile. Returns (color (H, W, C), alpha (H, W),
    livecnt (H, W) int32, t_final (H, W))."""
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    n, C = colors.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"1 <= channels <= {MAX_CHANNELS} required, got {C}")
    tiles_w = -(-width // tile_size)
    tiles_h = -(-height // tile_size)
    dev = means2d.device
    for name, t, dt, shape in (
        ("means2d", means2d, torch.float32, (n, 2)),
        ("conics", conics, torch.float32, (n, 3)),
        ("colors", colors, torch.float32, (n, C)),
        ("opacities", opacities, torch.float32, (n,)),
        ("radii", radii, torch.float32, (n,)),
        ("gauss_ids", gauss_ids, torch.int32, None),
        ("tile_offsets", tile_offsets, torch.int32, (tiles_w * tiles_h + 1,)),
    ):
        _check(name, t, dt, dev, shape)
    if dev.type == "cpu":
        return rasterize_tiles_plain(
            means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, width, height, tile_size
        )
    if dev.type != "cuda":
        raise ValueError(f"rasterize_tiles runs on cuda or cpu tensors, got {dev}")

    fn, err = _kernel()
    color = torch.empty((height, width, C), dtype=torch.float32, device=dev)
    alpha = torch.empty((height, width), dtype=torch.float32, device=dev)
    livecnt = torch.empty((height, width), dtype=torch.int32, device=dev)
    t_final = torch.empty((height, width), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(
        means2d.data_ptr(), conics.data_ptr(), opacities.data_ptr(), colors.data_ptr(),
        radii.data_ptr(), gauss_ids.data_ptr(), tile_offsets.data_ptr(),
        C, width, height, tile_size, tiles_w, tiles_h, int(tile_size != CONTRACT_TILE),
        color.data_ptr(), alpha.data_ptr(), livecnt.data_ptr(), t_final.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"rasterize_fwd launch failed: {err(rc).decode()} (cudaError {rc})")
    LAUNCHES["rasterize_fwd"] += 1
    return color, alpha, livecnt, t_final


def _sequential_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod along the last axis as a left-to-right running product, so every
    partial product rounds exactly as the kernel's `T *= 1 - alpha` does
    (torch.cumprod on CUDA is a parallel scan with another rounding order,
    which could flip a termination decision sitting on the 1e-4 threshold)."""
    out = torch.empty_like(x)
    run = torch.ones_like(x[..., 0])
    for k in range(x.shape[-1]):
        run = run * x[..., k]
        out[..., k] = run
    return out


def rasterize_tiles_plain(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets,
    width: int, height: int, tile_size: int,
):
    """Plain PyTorch version of `rasterize_tiles` (same inputs, same outputs).

    Tiles are taken in order of their intersection count, in batches whose
    padded (tiles, P, K_max) blocks hold at most `PLAIN_BATCH_ELEMENTS`
    pairs; each batch composites all its pairs at once with the same
    termination rule."""
    dev = means2d.device
    C = colors.shape[1]
    ts = tile_size
    P = ts * ts
    tiles_w = -(-width // ts)
    tiles_h = -(-height // ts)
    num_tiles = tiles_w * tiles_h
    offs = tile_offsets.long()
    starts = offs[:-1]
    counts = offs[1:] - starts
    gate = ts != CONTRACT_TILE
    g = float(CONTRACT_TILE)

    color_t = torch.zeros((num_tiles, P, C), dtype=torch.float32, device=dev)
    alpha_t = torch.zeros((num_tiles, P), dtype=torch.float32, device=dev)
    live_t = torch.zeros((num_tiles, P), dtype=torch.int32, device=dev)
    tfin_t = torch.ones((num_tiles, P), dtype=torch.float32, device=dev)

    pix = torch.arange(P, device=dev)
    order = torch.argsort(counts, stable=True)
    counts_sorted = counts[order].tolist()
    i = 0
    while i < num_tiles:
        # counts ascend, so a batch's K_max is its last tile's count
        j = i + 1
        while j < num_tiles and (j + 1 - i) * P * max(counts_sorted[j], 1) <= PLAIN_BATCH_ELEMENTS:
            j += 1
        k_max = max(counts_sorted[j - 1], 1)
        tiles = order[i:j]
        i = j
        cnt = counts[tiles]
        if int(cnt.max()) == 0:
            continue
        k = torch.arange(k_max, device=dev)
        valid = k[None, :] < cnt[:, None]  # (B, K)
        slot = torch.clamp(starts[tiles][:, None] + k[None, :], max=max(gauss_ids.shape[0] - 1, 0))
        gid = gauss_ids.long()[slot]  # (B, K)
        gx = means2d[gid, 0][:, None, :]  # (B, 1, K)
        gy = means2d[gid, 1][:, None, :]
        ca = conics[gid, 0][:, None, :]
        cb = conics[gid, 1][:, None, :]
        cc = conics[gid, 2][:, None, :]
        op = opacities[gid][:, None, :]
        px = ((tiles % tiles_w)[:, None] * ts + pix[None, :] % ts).float()[..., None] + 0.5  # (B, P, 1)
        py = ((tiles // tiles_w)[:, None] * ts + pix[None, :] // ts).float()[..., None] + 0.5

        dx = gx - px  # (B, P, K)
        dy = gy - py
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp(op * torch.exp(-sigma), max=MAX_ALPHA)
        vis = valid[:, None, :] & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD)
        if gate:
            r = radii[gid][:, None, :]
            tx = torch.floor((px - 0.5) / g)
            ty = torch.floor((py - 0.5) / g)
            vis = (
                vis
                & (tx >= torch.floor((gx - r) / g)) & (tx < torch.ceil((gx + r) / g))
                & (ty >= torch.floor((gy - r) / g)) & (ty < torch.ceil((gy + r) / g))
            )
        a_eff = torch.where(vis, alpha, torch.zeros_like(alpha))
        incl_T = _sequential_cumprod(1.0 - a_eff)
        excl_T = torch.cat([torch.ones_like(incl_T[..., :1]), incl_T[..., :-1]], dim=-1)
        terminated = torch.cummax((incl_T <= TRANSMITTANCE_EPS).to(torch.int32), dim=-1).values > 0
        w = torch.where(vis & ~terminated, a_eff * excl_T, torch.zeros_like(a_eff))

        col = colors[gid]  # (B, K, C)
        color_t[tiles] = torch.einsum("bpk,bkc->bpc", w, col)
        alpha_t[tiles] = w.sum(-1)
        walked = (valid[:, None, :] & ~terminated).sum(-1).to(torch.int32)  # (B, P)
        live_t[tiles] = walked
        last = torch.clamp(walked.long() - 1, min=0)[..., None]
        tfin_t[tiles] = torch.where(walked > 0, incl_T.gather(-1, last)[..., 0], torch.ones_like(w[..., 0]))

    def to_image(x):
        # (T, P, ...) tile layout -> (H, W, ...) image layout
        rest = x.shape[2:]
        x = x.reshape(tiles_h, tiles_w, ts, ts, *rest).transpose(1, 2)
        return x.reshape(tiles_h * ts, tiles_w * ts, *rest)[:height, :width].contiguous()

    return to_image(color_t), to_image(alpha_t), to_image(live_t), to_image(tfin_t)


def rasterize_pixels(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    width: int,
    height: int,
    *,
    tile_size: int = 16,
):
    """Tile-rasterize pre-projected Gaussians. Returns
    (render (H, W, C), alpha (H, W, 1), num_isects)."""
    isect = build_intersections(means2d, radii, depths, width, height, tile_size)
    color, alpha, _, _ = rasterize_tiles(
        means2d.float().contiguous(),
        conics.float().contiguous(),
        colors.float().contiguous(),
        opacities.float().contiguous(),
        radii.float().contiguous(),
        isect.gauss_ids,
        isect.tile_offsets,
        width,
        height,
        tile_size,
    )
    return color, alpha[..., None], isect.num_isects
