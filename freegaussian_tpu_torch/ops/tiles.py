"""Tile binning: expand Gaussians into (tile, depth)-sorted intersections.

Torch twin of `freegaussian_tpu/ops/tiles.py:build_intersections` without
the ellipse cull (the JAX pixel path runs it off by default):

  1. per-Gaussian overlapped-tile counts from the radius bbox
  2. exclusive cumsum -> per-Gaussian slot offsets
  3. expansion of each Gaussian into its tiles (row-major within its bbox)
  4. a stable sort on (tile, depth)
  5. the per-tile offset table

Two deliberate differences from the TPU version:
  - torch has dynamic shapes, so exactly `num_isects` slots are allocated.
    The TPU drops slots past a static capacity; this never drops any.
  - the sort key is the JAX package's: one key `tile << 20 | min(depth_bits
    >> 11, 2^20 - 1)` when `num_tiles < 2^11` (ties within 2^-12 relative
    depth keep expansion order), else the exact (tile, depth) order as one
    64-bit key `tile << 32 | depth_bits`. Both sorts are stable, so the
    order matches the JAX package's tie for tie.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rasterize_ref import tile_bounds


class Intersections(NamedTuple):
    gauss_ids: torch.Tensor  # (num_isects,) int32 Gaussian index, (tile, depth) order
    tile_ids: torch.Tensor  # (num_isects,) int32 row-major tile index
    tile_offsets: torch.Tensor  # (num_tiles + 1,) int32 range of each tile
    num_isects: int
    counts: torch.Tensor  # (N,) int32 slots per Gaussian
    offsets: torch.Tensor  # (N,) int32 exclusive cumsum of counts
    num_tiles: int
    tiles_w: int
    tiles_h: int


def build_intersections(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    depths: torch.Tensor,
    width: int,
    height: int,
    tile_size: int,
) -> Intersections:
    dev = means2d.device
    n = means2d.shape[0]
    tiles_w = -(-width // tile_size)
    tiles_h = -(-height // tile_size)
    num_tiles = tiles_w * tiles_h

    tminx, tmaxx, tminy, tmaxy = tile_bounds(means2d, radii, tile_size, tiles_w, tiles_h)
    dx = (tmaxx - tminx).long()
    dy = (tmaxy - tminy).long()
    # depth <= 0 never rasterizes (and would break the depth-bits key)
    counts = torch.where((radii > 0) & (depths > 0), dx * dy, torch.zeros_like(dx))
    offsets = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())

    gid = torch.repeat_interleave(torch.arange(n, device=dev), counts, output_size=total)
    local = torch.arange(total, device=dev) - offsets[gid]
    gdx = dx[gid]
    tile_x = tminx.long()[gid] + local % gdx
    tile_y = tminy.long()[gid] + torch.div(local, gdx, rounding_mode="floor")
    tile_id = tile_y * tiles_w + tile_x
    # positive f32 bit patterns order like the floats
    dbits = torch.clamp(depths.float(), min=0.0).view(torch.int32).long()[gid]

    if num_tiles < (1 << 11):
        key = tile_id * (1 << 20) + torch.clamp(dbits >> 11, max=(1 << 20) - 1)
        key_sorted, order = torch.sort(key, stable=True)
        tile_sorted = key_sorted >> 20
    else:
        key = tile_id * (1 << 32) + dbits
        key_sorted, order = torch.sort(key, stable=True)
        tile_sorted = key_sorted >> 32
    gid_sorted = gid[order]

    tile_offsets = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, device=dev, dtype=tile_sorted.dtype), side="left"
    )
    return Intersections(
        gauss_ids=gid_sorted.to(torch.int32),
        tile_ids=tile_sorted.to(torch.int32),
        tile_offsets=tile_offsets.to(torch.int32),
        num_isects=total,
        counts=counts.to(torch.int32),
        offsets=offsets.to(torch.int32),
        num_tiles=num_tiles,
        tiles_w=tiles_w,
        tiles_h=tiles_h,
    )
