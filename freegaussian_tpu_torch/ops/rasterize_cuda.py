"""The tile compositor and its backward: CUDA kernel wrappers and their plain
PyTorch versions.

`rasterize_tiles` takes the binned intersections of `ops/tiles.py` and
composites every tile front to back. On a CUDA tensor it launches the kernel
of `csrc/rasterize_fwd.cu` (the port of the TPU kernel
`freegaussian_tpu/ops/rasterize_pallas.py:_fwd_kernel`) or raises; on a CPU
tensor it runs `rasterize_tiles_plain`, which computes the same function
with padded (tiles, pixels, K) tensors.

`rasterize_tiles_bwd` is its backward: one gradient row per intersection
(d means2d, d conic, d opacity, the AbsGS absgrad |sum over the tile of
d means2d|, d colors). On a CUDA tensor it launches `csrc/rasterize_bwd.cu`
(the port of `rasterize_pallas.py:_bwd_kernel_rev`) or raises; on a CPU
tensor it runs `rasterize_tiles_bwd_plain`, autograd through the plain
forward with respect to the gathered per-intersection rows.
`rasterize_tiles_bwd_fwd` computes the same rows by the forward walk (the
port of `rasterize_pallas.py:_bwd_kernel`, kernel `rasterize_bwd_fwd` of
`csrc/rasterize_bwd.cu`) from the per-pixel totals r_total; `BWD_WALK`
picks the walk, as the module knob of the same name does in the JAX package.
`reduce_rows_by_gid` sums the rows per Gaussian (the twin of
`rasterize_pallas.py:_reduce_rows_by_gid`).

`rasterize_pixels` is the pixel stage end to end (binning, then the
differentiable compositor), the twin of `rasterize_pixels_pallas`.
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
# Columns of one backward row ahead of the C color columns: d means2d (2),
# d conic (3), d opacity (1), absgrad (2)
GRAD_ROW_HEAD = 8

# Kernel launches by kernel name. Each wrapper adds one where it launches its
# kernel and nowhere else; `chip_smoke.py` zeroes and reads it.
LAUNCHES = {"rasterize_fwd": 0, "rasterize_bwd": 0, "rasterize_bwd_fwd": 0}
# The CUDA sources (csrc/<name>.cu) this module launches.
KERNEL_SOURCES = ("rasterize_fwd", "rasterize_bwd")

# The backward's walk order, the twin of `rasterize_pallas.BWD_WALK`: "rev"
# (the reverse walk from t_final) or "fwd" (the forward walk with the suffix
# identity, whose subtraction cancels where the suffix is small).
BWD_WALK = "rev"

# (source, ctypes argument layout) of each kernel's C entry point
_ENTRIES = {
    "rasterize_fwd": ("rasterize_fwd", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5),
    "rasterize_bwd": ("rasterize_bwd", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2),
    "rasterize_bwd_fwd": ("rasterize_bwd", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2),
}
_fns: dict = {}


def _kernel(name: str):
    """(entry point, error-string function) of the kernel `name`, its source built at first use."""
    if name not in _fns:
        from ..cuda_build import load

        source, argtypes = _ENTRIES[name]
        lib = load(source)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[name] = (fn, err)
    return _fns[name]


def _check(name, t, dtype, device, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_inputs(means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, width, height, tile_size):
    """Validate the compositor's inputs; returns (C, tiles_w, tiles_h)."""
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the compositor runs on cuda or cpu tensors, got {dev}")
    return C, tiles_w, tiles_h


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
    C, tiles_w, tiles_h = _check_inputs(
        means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, width, height, tile_size
    )
    dev = means2d.device
    if dev.type == "cpu":
        return rasterize_tiles_plain(
            means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, width, height, tile_size
        )

    fn, err = _kernel("rasterize_fwd")
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


def rasterize_tiles_bwd(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets,
    livecnt: torch.Tensor,  # (H, W) int32, from the forward
    t_final: torch.Tensor,  # (H, W) f32, from the forward
    g_color: torch.Tensor,  # (H, W, C) f32 cotangent of the color image
    g_alpha: torch.Tensor,  # (H, W) f32 cotangent of the alpha image
    width: int,
    height: int,
    tile_size: int,
) -> torch.Tensor:
    """Per-intersection gradient rows (I, 8 + C): [d mx, d my, d conic a, b,
    c, d opacity, |d mx|, |d my|, d colors], where |.| is taken after the sum
    over the intersection's whole tile (one row is one (tile, Gaussian)
    pair). Every row is written: slots past every pixel's termination get
    exact zeros. The reverse walk, from the forward's t_final."""
    return _bwd("rasterize_bwd", means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets,
                livecnt, t_final, g_color, g_alpha, width, height, tile_size)


def rasterize_tiles_bwd_fwd(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets,
    livecnt: torch.Tensor,  # (H, W) int32, from the forward
    r_total: torch.Tensor,  # (H, W) f32: sum_c color g_color + alpha g_alpha
    g_color: torch.Tensor,
    g_alpha: torch.Tensor,
    width: int,
    height: int,
    tile_size: int,
) -> torch.Tensor:
    """`rasterize_tiles_bwd`'s rows by the forward walk, which replays the
    forward's transmittance and takes each suffix as r_total minus the
    running sum (`r_total` from the forward's color and alpha images)."""
    return _bwd("rasterize_bwd_fwd", means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets,
                livecnt, r_total, g_color, g_alpha, width, height, tile_size)


def _bwd(name, means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, livecnt, pixel_in,
         g_color, g_alpha, width, height, tile_size):
    """Check the backward's inputs and launch kernel `name` (`pixel_in` is
    t_final for the reverse walk, r_total for the forward walk); on CPU
    tensors, run the plain version, the same function for both walks."""
    C, tiles_w, tiles_h = _check_inputs(
        means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, width, height, tile_size
    )
    dev = means2d.device
    for arg, t, dt, shape in (
        ("livecnt", livecnt, torch.int32, (height, width)),
        ("t_final" if name == "rasterize_bwd" else "r_total", pixel_in, torch.float32, (height, width)),
        ("g_color", g_color, torch.float32, (height, width, C)),
        ("g_alpha", g_alpha, torch.float32, (height, width)),
    ):
        _check(arg, t, dt, dev, shape)
    if dev.type == "cpu":
        return rasterize_tiles_bwd_plain(
            means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, g_color, g_alpha,
            width, height, tile_size,
        )

    fn, err = _kernel(name)
    rows = torch.empty((gauss_ids.shape[0], GRAD_ROW_HEAD + C), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(
        means2d.data_ptr(), conics.data_ptr(), opacities.data_ptr(), colors.data_ptr(),
        radii.data_ptr(), gauss_ids.data_ptr(), tile_offsets.data_ptr(),
        g_color.data_ptr(), g_alpha.data_ptr(), livecnt.data_ptr(), pixel_in.data_ptr(),
        C, width, height, tile_size, tiles_w, tiles_h, int(tile_size != CONTRACT_TILE),
        rows.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()} (cudaError {rc})")
    LAUNCHES[name] += 1
    return rows


def _sequential_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod along the last axis as a left-to-right running product, so every
    partial product rounds exactly as the kernel's `T *= 1 - alpha` does
    (torch.cumprod on CUDA is a parallel scan with another rounding order,
    which could flip a termination decision sitting on the 1e-4 threshold).
    Stacked rather than written in place, so autograd through it stays
    linear in the length."""
    run = torch.ones_like(x[..., 0])
    out = []
    for k in range(x.shape[-1]):
        run = run * x[..., k]
        out.append(run)
    return torch.stack(out, dim=-1)


def _slot_rows(means2d, conics, colors, opacities, gauss_ids):
    """The per-intersection rows [mx, my, ca, cb, cc, op, colors] (I, 6 + C)."""
    per_gauss = torch.cat([means2d, conics, opacities[:, None], colors], dim=1)
    return per_gauss[gauss_ids.long()]


def rasterize_tiles_plain(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets,
    width: int, height: int, tile_size: int,
):
    """Plain PyTorch version of `rasterize_tiles` (same inputs, same outputs)."""
    rows = _slot_rows(means2d, conics, colors, opacities, gauss_ids)
    return _composite_plain(rows, radii[gauss_ids.long()], tile_offsets, width, height, tile_size)


def _composite_plain(rows, slot_radii, tile_offsets, width: int, height: int, tile_size: int):
    """Composite per-intersection rows (I, 6 + C) in their (tile, depth)
    order. Tiles are taken in order of their intersection count, in batches
    whose padded (tiles, P, K_max) blocks hold at most `PLAIN_BATCH_ELEMENTS`
    pairs; each batch composites all its pairs at once with the same
    termination rule. Differentiable in `rows`."""
    dev = rows.device
    C = rows.shape[1] - 6
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

    dt = rows.dtype
    color_t = torch.zeros((num_tiles, P, C), dtype=dt, device=dev)
    alpha_t = torch.zeros((num_tiles, P), dtype=dt, device=dev)
    live_t = torch.zeros((num_tiles, P), dtype=torch.int32, device=dev)
    tfin_t = torch.ones((num_tiles, P), dtype=dt, device=dev)

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
        slot = torch.clamp(starts[tiles][:, None] + k[None, :], max=max(rows.shape[0] - 1, 0))
        data = rows[slot]  # (B, K, 6 + C)
        gx = data[..., 0][:, None, :]  # (B, 1, K)
        gy = data[..., 1][:, None, :]
        ca = data[..., 2][:, None, :]
        cb = data[..., 3][:, None, :]
        cc = data[..., 4][:, None, :]
        op = data[..., 5][:, None, :]
        px = ((tiles % tiles_w)[:, None] * ts + pix[None, :] % ts).to(dt)[..., None] + 0.5  # (B, P, 1)
        py = ((tiles // tiles_w)[:, None] * ts + pix[None, :] // ts).to(dt)[..., None] + 0.5

        dx = gx - px  # (B, P, K)
        dy = gy - py
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp(op * torch.exp(-sigma), max=MAX_ALPHA)
        vis = valid[:, None, :] & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD)
        if gate:
            r = slot_radii[slot][:, None, :]
            gxd, gyd = gx.detach(), gy.detach()
            tx = torch.floor((px - 0.5) / g)
            ty = torch.floor((py - 0.5) / g)
            vis = (
                vis
                & (tx >= torch.floor((gxd - r) / g)) & (tx < torch.ceil((gxd + r) / g))
                & (ty >= torch.floor((gyd - r) / g)) & (ty < torch.ceil((gyd + r) / g))
            )
        a_eff = torch.where(vis, alpha, torch.zeros_like(alpha))
        incl_T = _sequential_cumprod(1.0 - a_eff)
        excl_T = torch.cat([torch.ones_like(incl_T[..., :1]), incl_T[..., :-1]], dim=-1)
        terminated = torch.cummax((incl_T <= TRANSMITTANCE_EPS).to(torch.int32), dim=-1).values > 0
        w = torch.where(vis & ~terminated, a_eff * excl_T, torch.zeros_like(a_eff))

        col = data[..., 6:]  # (B, K, C)
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


def rasterize_tiles_bwd_plain(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, g_color, g_alpha,
    width: int, height: int, tile_size: int,
) -> torch.Tensor:
    """Plain PyTorch version of `rasterize_tiles_bwd`: autograd through the
    plain forward with respect to the gathered per-intersection rows, which
    gives each row's gradient independently of the kernel's algebra. The
    absgrad of a row is the abs of its means2d gradient (one row is one
    (tile, Gaussian) pair, so that gradient is already the tile's sum)."""
    ids = gauss_ids.long()
    rows = _slot_rows(means2d, conics, colors, opacities, gauss_ids).detach().requires_grad_(True)
    C = colors.shape[1]
    d_rows = None
    if rows.shape[0] > 0:
        with torch.enable_grad():
            color, alpha, _, _ = _composite_plain(rows, radii[ids], tile_offsets, width, height, tile_size)
            if color.requires_grad:
                (d_rows,) = torch.autograd.grad((color, alpha), rows, (g_color, g_alpha), allow_unused=True)
    if d_rows is None:
        d_rows = torch.zeros_like(rows)
    d_rows = d_rows.detach()
    return torch.cat([d_rows[:, :6], d_rows[:, :2].abs(), d_rows[:, 6 : 6 + C]], dim=1)


def reduce_rows_by_gid(
    rows: torch.Tensor,  # (I, D) per-intersection rows
    gauss_ids: torch.Tensor,  # (I,) int32
    offsets: torch.Tensor,  # (N,) exclusive cumsum of counts
    counts: torch.Tensor,  # (N,) slots per Gaussian
) -> torch.Tensor:
    """Deterministic per-Gaussian sum of per-intersection rows (the twin of
    `rasterize_pallas.py:_reduce_rows_by_gid`): a stable sort by Gaussian id,
    an f32 prefix sum, and differences at the group boundaries. Groups are
    contiguous after the sort and sized `counts`. The prefix sum runs along
    the last axis of the transposed (D, I) rows: on CUDA a scan over the
    outer axis of (I, D) is some 300x slower. Returns (N, D) f32."""
    order = torch.argsort(gauss_ids, stable=True)
    cs = torch.cumsum(rows[order].float().t().contiguous(), dim=1)  # (D, I)
    cs = torch.cat([cs.new_zeros((rows.shape[1], 1)), cs], dim=1)
    lo = offsets.long()
    hi = lo + counts.long()
    return (cs[:, hi] - cs[:, lo]).t()


class _PixelStage(torch.autograd.Function):
    """The compositor with its backward: forward `rasterize_tiles`, backward
    `rasterize_tiles_bwd` (or, with BWD_WALK "fwd", `rasterize_tiles_bwd_fwd`
    from the forward's color and alpha) then `reduce_rows_by_gid`.
    Differentiable inputs: means2d, conics, colors (all C channels),
    opacities, and the absgrad sink, whose gradient is the per-Gaussian sum
    over kernel tiles of |sum over the tile of d means2d|. Radii and the
    binning are cuts."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, sink, radii, isect, width, height, tile_size):
        color, alpha, livecnt, t_final = rasterize_tiles(
            means2d, conics, colors, opacities, radii, isect.gauss_ids, isect.tile_offsets,
            width, height, tile_size,
        )
        ctx.walk = BWD_WALK
        if ctx.walk not in ("rev", "fwd"):
            raise ValueError(f"BWD_WALK must be 'rev' or 'fwd', got {ctx.walk!r}")
        pixel_saved = (t_final,) if ctx.walk == "rev" else (color, alpha)
        ctx.save_for_backward(means2d, conics, colors, opacities, radii, livecnt, *pixel_saved)
        ctx.isect = isect
        ctx.size = (width, height, tile_size)
        ctx.has_sink = sink is not None
        return color, alpha

    @staticmethod
    def backward(ctx, g_color, g_alpha):
        means2d, conics, colors, opacities, radii, livecnt, *pixel_saved = ctx.saved_tensors
        isect = ctx.isect
        width, height, tile_size = ctx.size
        g_color = g_color.float().contiguous()
        g_alpha = g_alpha.float().contiguous()
        args = (means2d, conics, colors, opacities, radii, isect.gauss_ids, isect.tile_offsets, livecnt)
        if ctx.walk == "rev":
            rows = rasterize_tiles_bwd(*args, pixel_saved[0], g_color, g_alpha, width, height, tile_size)
        else:
            color, alpha = pixel_saved
            # the per-pixel total, outside the kernel as in the JAX package
            r_total = ((color * g_color).sum(-1) + alpha * g_alpha).contiguous()
            rows = rasterize_tiles_bwd_fwd(*args, r_total, g_color, g_alpha, width, height, tile_size)
        g = reduce_rows_by_gid(rows, isect.gauss_ids, isect.offsets, isect.counts)
        d_sink = g[:, 6:8] if ctx.has_sink else None
        return g[:, 0:2], g[:, 2:5], g[:, GRAD_ROW_HEAD:], g[:, 5], d_sink, None, None, None, None, None


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
    means2d_sink: torch.Tensor | None = None,
):
    """Tile-rasterize pre-projected Gaussians. Returns
    (render (H, W, C), alpha (H, W, 1), num_isects). Differentiable in
    means2d, conics, colors and opacities; `means2d_sink` (N, 2), zeros,
    receives the AbsGS absgrad as its gradient (per kernel tile)."""
    isect = build_intersections(means2d.detach(), radii, depths.detach(), width, height, tile_size)
    color, alpha = _PixelStage.apply(
        means2d.float().contiguous(),
        conics.float().contiguous(),
        colors.float().contiguous(),
        opacities.float().contiguous(),
        means2d_sink,
        radii.detach().float().contiguous(),
        isect,
        width,
        height,
        tile_size,
    )
    return color, alpha[..., None], isect.num_isects
