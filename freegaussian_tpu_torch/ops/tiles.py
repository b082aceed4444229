"""Tile binning: expand Gaussians into (tile, depth)-sorted intersections.

Torch twin of `freegaussian_tpu/ops/tiles.py:build_intersections`:

  1. per-Gaussian overlapped-tile counts from the radius bbox
  2. exclusive cumsum -> per-Gaussian slot offsets
  3. expansion of each Gaussian into its tiles (row-major within its bbox)
  4. a stable sort on (tile, depth)
  5. the per-tile offset table

Two forms of the same binning:
  - `capacity=None`: exactly `num_isects` slots (a host int, read with one
    host synchronisation), nothing dropped. The plain versions, `packed`
    mode and the parity tests of the compositor use it.
  - `capacity=C`: the JAX package's static form. Every output has C slots
    and nothing waits on the host, so the binning can be captured in a CUDA
    graph. Padding slots carry `gauss_ids == N` and `tile_ids == num_tiles`
    and sort last. `num_isects` is a 0-d device tensor with the total before
    the clamp; on overflow the slots past C in expansion order are dropped
    (the deepest tiles of the last Gaussians), the same pairs as the JAX
    package drops. With `conics` and `opacities` it also runs the exact
    ellipse cull (`_ellipse_cull_test`): with `precull`, Gaussians whose
    bbox fits PRECULL_T_MAX tiles are culled before slot assignment, larger
    ones after expansion, with `counts` / `offsets` rebased to the kept
    slots.

The sort key is the JAX package's: one key `tile << 20 | min(depth_bits
>> 11, 2^20 - 1)` when `num_tiles < 2^11` (ties within 2^-12 relative depth
keep expansion order), else the exact (tile, depth) order as one 64-bit key
`tile << 32 | depth_bits`. Padding and culled slots carry depth +inf and
tile `num_tiles`, so their keys sort after every real slot on both paths.
Both sorts are stable, so the order matches the JAX package's tie for tie.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from .rasterize_ref import ALPHA_THRESHOLD, tile_bounds

# bbox-tile budget for the pre-expansion ellipse cull (the JAX package's)
PRECULL_T_MAX = 32


class Intersections(NamedTuple):
    gauss_ids: torch.Tensor  # (I,) int32 Gaussian index, (tile, depth) order; N for padding
    tile_ids: torch.Tensor  # (I,) int32 row-major tile index; num_tiles for padding
    tile_offsets: torch.Tensor  # (num_tiles + 1,) int32 range of each tile
    num_isects: Union[int, torch.Tensor]  # total before the clamp: an int, or 0-d int32 with a capacity
    counts: torch.Tensor  # (N,) int32 kept slots per Gaussian
    offsets: torch.Tensor  # (N,) int32 exclusive cumsum of counts
    num_tiles: int
    tiles_w: int
    tiles_h: int


def _ellipse_cull_test(ca, cb, cd, qmax, mx, my, tile_x, tile_y, tile_size: int) -> torch.Tensor:
    """True where the Gaussian's threshold ellipse cannot touch the tile (the
    JAX package's test, operation for operation): the minimum over the tile's
    pixel-center rectangle of q(p) = a dx^2 + 2b dx dy + c dy^2 exceeds
    qmax = 2 ln(op / ALPHA_THRESHOLD) by a margin that covers f32 rounding,
    so a culled pair is one the compositor skips at every pixel. All
    arguments broadcast."""
    ts = float(tile_size)
    x0 = tile_x.float() * ts + 0.5
    x1 = x0 + (ts - 1.0)
    y0 = tile_y.float() * ts + 0.5
    y1 = y0 + (ts - 1.0)
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)

    def edge_min(ex, ey, vx, vy):
        dx0 = ex - mx
        dy0 = ey - my
        q0 = ca * dx0 * dx0 + 2.0 * cb * dx0 * dy0 + cd * dy0 * dy0
        g = ca * dx0 * vx + cb * (dx0 * vy + dy0 * vx) + cd * dy0 * vy
        h = ca * vx * vx + 2.0 * cb * vx * vy + cd * vy * vy
        s = torch.clamp(-g / torch.clamp(h, min=1e-12), 0.0, 1.0)
        # the size of the near-cancelling terms bounds the sum's f32 error
        mag = q0 + 2.0 * torch.abs(s * g) + s * s * h
        return q0 + 2.0 * s * g + s * s * h, mag

    w = x1 - x0
    zero = torch.zeros_like(w)
    q_b, m_b = edge_min(x0, y0, w, zero)
    q_t, m_t = edge_min(x0, y1, w, zero)
    q_l, m_l = edge_min(x0, y0, zero, w)
    q_r, m_r = edge_min(x1, y0, zero, w)
    min_q = torch.minimum(torch.minimum(q_b, q_t), torch.minimum(q_l, q_r))
    min_q = torch.where(inside, torch.zeros_like(min_q), min_q)
    mag = torch.maximum(torch.maximum(m_b, m_t), torch.maximum(m_l, m_r))
    # only genuinely PSD conics are culled (the compositor's sigma >= 0 skip
    # handles degenerate ones)
    psd = (ca > 0) & (ca * cd - cb * cb > 0)
    margin = 1e-3 + 1e-4 * qmax + 1e-5 * mag
    return psd & (min_q > qmax + margin)


def _sort_by_tile_depth(tile_id: torch.Tensor, depth: torch.Tensor, gid: torch.Tensor, num_tiles: int):
    """(tile_sorted, gid_sorted, tile_offsets) of a stable (tile, depth) sort
    with the JAX package's key; depth >= 0 (+inf for padding)."""
    dbits = torch.clamp(depth.float(), min=0.0).view(torch.int32).long()
    tile_id = tile_id.long()
    if num_tiles < (1 << 11):
        key = tile_id * (1 << 20) + torch.clamp(dbits >> 11, max=(1 << 20) - 1)
        key_sorted, order = torch.sort(key, stable=True)
        tile_sorted = key_sorted >> 20
    else:
        key = tile_id * (1 << 32) + dbits
        key_sorted, order = torch.sort(key, stable=True)
        tile_sorted = key_sorted >> 32
    tile_offsets = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, device=tile_id.device, dtype=tile_sorted.dtype), side="left"
    )
    return tile_sorted.to(torch.int32), gid[order].to(torch.int32), tile_offsets.to(torch.int32)


def build_intersections(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    depths: torch.Tensor,
    width: int,
    height: int,
    tile_size: int,
    capacity: int | None = None,
    conics: torch.Tensor | None = None,
    opacities: torch.Tensor | None = None,
    precull: bool = True,
) -> Intersections:
    """Bin the Gaussians into (tile, depth) order. `capacity`: the static
    form (see the module docstring); `conics` (N, 3) and `opacities` (N,)
    turn on its exact ellipse cull, `precull` its pre-expansion form."""
    if capacity is None:
        if conics is not None:
            raise ValueError("the ellipse cull runs in the capacity-bounded binning: pass a capacity")
        return _build_exact(means2d, radii, depths, width, height, tile_size)
    dev = means2d.device
    n = means2d.shape[0]
    tiles_w = -(-width // tile_size)
    tiles_h = -(-height // tile_size)
    num_tiles = tiles_w * tiles_h

    tminx, tmaxx, tminy, tmaxy = tile_bounds(means2d, radii, tile_size, tiles_w, tiles_h)
    dx = (tmaxx - tminx).long()
    dy = (tmaxy - tminy).long()
    tminx, tminy = tminx.long(), tminy.long()
    # depth <= 0 never rasterizes (and would break the depth-bits key)
    counts = torch.where((radii > 0) & (depths > 0), dx * dy, torch.zeros_like(dx))
    dxm = torch.clamp(dx, min=1)

    tile_tab = small = None
    if conics is not None:
        op = opacities.detach().float()
        con = conics.detach().float()
        m2d = means2d.detach().float()
        # the compositor skips alpha = op exp(-q / 2) < T, i.e. q > 2 ln(op / T)
        qmax = 2.0 * torch.log(torch.clamp(op, min=1e-30) / ALPHA_THRESHOLD)
        if precull:
            # the test over each small bbox's whole grid of tiles, before slot
            # assignment: culled pairs never take a slot, so num_isects counts
            # kept pairs; the kept tiles go first in a per-Gaussian table
            T = PRECULL_T_MAX
            jj = torch.arange(T, device=dev)[None, :]
            txg = tminx[:, None] + jj % dxm[:, None]
            tyg = tminy[:, None] + torch.div(jj, dxm[:, None], rounding_mode="floor")
            small = counts <= T
            validj = jj < counts[:, None]
            cull = _ellipse_cull_test(
                con[:, 0:1], con[:, 1:2], con[:, 2:3], qmax[:, None], m2d[:, 0:1], m2d[:, 1:2], txg, tyg, tile_size
            )
            keepj = validj & ~cull
            counts = torch.where(small, keepj.sum(1), counts)
            key = torch.where(keepj, jj, T + jj)
            tile_tab = (tyg * tiles_w + txg).gather(1, torch.sort(key, dim=1).indices)

    cum = torch.cumsum(counts, 0)
    offsets = cum - counts
    total = cum[-1] if n > 0 else torch.zeros((), dtype=torch.long, device=dev)
    slots = torch.arange(capacity, device=dev)
    # the owner of slot s: the Gaussian whose [offset, offset + count) holds it
    gid = torch.clamp(torch.searchsorted(cum, slots, right=True), max=max(n - 1, 0))
    slot_valid = slots < torch.clamp(total, max=capacity)

    local = slots - offsets[gid]
    gdx = dxm[gid]
    tile_x = tminx[gid] + local % gdx
    tile_y = tminy[gid] + torch.div(local, gdx, rounding_mode="floor")
    tile_id = tile_y * tiles_w + tile_x
    depth = depths.detach().float()[gid]

    if conics is not None:
        if tile_tab is not None:
            # small-bbox slots read their pre-culled tile from the table
            small_row = small[gid]
            loc = torch.clamp(local, 0, PRECULL_T_MAX - 1)[:, None]
            tile_id = torch.where(small_row, tile_tab[gid].gather(1, loc)[:, 0], tile_id)
        test = lambda: _ellipse_cull_test(
            con[gid, 0], con[gid, 1], con[gid, 2], qmax[gid], m2d[gid, 0], m2d[gid, 1], tile_x, tile_y, tile_size
        )
        pruned = (~small_row & test()) if tile_tab is not None else test()
        tile_id = torch.where(pruned, num_tiles, tile_id)
        gid = torch.where(pruned, n, gid)
        # post-culled slots leave their Gaussian's group in the gradient
        # reduction: shrink each count by its pruned kept slots (each
        # Gaussian's slots are contiguous in expansion order)
        pr = (pruned & slot_valid).long()
        cs = torch.cat([pr.new_zeros(1), torch.cumsum(pr, 0)])
        bounds = torch.clamp(torch.cat([offsets, cum[-1:]]), 0, capacity)
        vals = cs[bounds]
        counts = counts - (vals[1:] - vals[:-1])
        offsets = torch.cumsum(counts, 0) - counts

    tile_id = torch.where(slot_valid, tile_id, num_tiles)
    gid = torch.where(slot_valid, gid, n)
    depth = torch.where(slot_valid & (tile_id < num_tiles), depth, torch.full_like(depth, float("inf")))
    tile_sorted, gid_sorted, tile_offsets = _sort_by_tile_depth(tile_id, depth, gid, num_tiles)
    return Intersections(
        gauss_ids=gid_sorted,
        tile_ids=tile_sorted,
        tile_offsets=tile_offsets,
        num_isects=total.to(torch.int32),
        counts=counts.to(torch.int32),
        offsets=offsets.to(torch.int32),
        num_tiles=num_tiles,
        tiles_w=tiles_w,
        tiles_h=tiles_h,
    )


def _build_exact(means2d, radii, depths, width: int, height: int, tile_size: int) -> Intersections:
    """The exact-size binning: `num_isects` slots, read on the host."""
    dev = means2d.device
    n = means2d.shape[0]
    tiles_w = -(-width // tile_size)
    tiles_h = -(-height // tile_size)
    num_tiles = tiles_w * tiles_h

    tminx, tmaxx, tminy, tmaxy = tile_bounds(means2d, radii, tile_size, tiles_w, tiles_h)
    dx = (tmaxx - tminx).long()
    dy = (tmaxy - tminy).long()
    counts = torch.where((radii > 0) & (depths > 0), dx * dy, torch.zeros_like(dx))
    offsets = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())

    gid = torch.repeat_interleave(torch.arange(n, device=dev), counts, output_size=total)
    local = torch.arange(total, device=dev) - offsets[gid]
    gdx = dx[gid]
    tile_x = tminx.long()[gid] + local % gdx
    tile_y = tminy.long()[gid] + torch.div(local, gdx, rounding_mode="floor")
    tile_sorted, gid_sorted, tile_offsets = _sort_by_tile_depth(
        tile_y * tiles_w + tile_x, depths.float()[gid], gid, num_tiles
    )
    return Intersections(
        gauss_ids=gid_sorted,
        tile_ids=tile_sorted,
        tile_offsets=tile_offsets,
        num_isects=total,
        counts=counts.to(torch.int32),
        offsets=offsets.to(torch.int32),
        num_tiles=num_tiles,
        tiles_w=tiles_w,
        tiles_h=tiles_h,
    )
