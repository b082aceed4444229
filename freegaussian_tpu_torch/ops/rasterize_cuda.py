"""The tile compositor and its backward: CUDA kernel wrappers and their plain
PyTorch versions.

`rasterize_tiles` takes the binned intersections of `ops/tiles.py` and
composites every tile front to back. On a CUDA tensor it launches the kernel
of `csrc/rasterize_fwd.cu` (the port of the TPU kernel
`freegaussian_tpu/ops/rasterize_pallas.py:_fwd_kernel`: a block per 16 x 16
quadrant of each tile, walking only the slots whose contract bbox holds the
quadrant) or raises; on a CPU tensor it runs `rasterize_tiles_plain`, which
computes the same function with padded (tiles, pixels, K) tensors.
`rasterize_tiles_quadrants_plain` is a plain model of the kernel's design,
which the tests hold to `rasterize_tiles_plain` bit for bit.

`rasterize_tiles_bwd` is its backward: one gradient row per intersection
(d means2d, d conic, d opacity, the AbsGS absgrad |sum over the tile of
d means2d|, d colors). On a CUDA tensor it launches `csrc/rasterize_bwd.cu`
(the port of `rasterize_pallas.py:_bwd_kernel_rev`: a walk per 16 x 16
quadrant of each tile into a scratch, then a combine that adds the
quadrants in order) or raises; on a CPU tensor it runs
`rasterize_tiles_bwd_plain`, autograd through the plain forward with
respect to the gathered per-intersection rows.
`rasterize_tiles_bwd_quadrants_plain` is a plain model of the kernels'
design (`quadrant_partials_plain`, then `combine_quadrants_plain`), which
the tests hold to both.
`rasterize_tiles_bwd_fwd` computes the same rows by the forward walk (the
port of `rasterize_pallas.py:_bwd_kernel`, kernel `rasterize_bwd_fwd` of
`csrc/rasterize_bwd.cu`) from the per-pixel totals r_total; `BWD_WALK`
picks the walk, as the module knob of the same name does in the JAX package.
`reduce_rows_by_gid` sums the rows per Gaussian (the twin of
`rasterize_pallas.py:_reduce_rows_by_gid`).

`rasterize_pixels` is the pixel stage end to end (binning, then the
differentiable compositor), the twin of `rasterize_pixels_pallas`. With a
`capacity` it bins into that many slots (`ops/tiles.py`): the slot lists
are then padded, with padding slots (`gauss_ids == N`) past every tile's
range. The walks read only the tiles' ranges, the combine writes a zero row
for a padding slot, and the per-Gaussian reduction clamps its groups to the
slot count, so padding and overflow leave the gradients of the kept pairs
as they are. ELLIPSE_CULL and PRECULL are the JAX package's knobs of the
same name (`rasterize_pallas.py`): the exact ellipse cull in the
capacity-bounded binning, off by default.
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

# The exact per-(Gaussian, tile) ellipse cull of the capacity-bounded binning
# (`tiles.py:_ellipse_cull_test`), off by default as in the JAX package, and
# its pre-expansion form.
ELLIPSE_CULL = False
PRECULL = True

# (source, ctypes argument layout) of each kernel's C entry point
_P, _I = ctypes.c_void_p, ctypes.c_int
_BWD_ARGS = [_P] * 11 + [_I] * 9 + [_P, _P, _I, _P]
_ENTRIES = {
    "rasterize_fwd": ("rasterize_fwd", [_P] * 7 + [_I] * 7 + [_P] * 5),
    "rasterize_bwd": ("rasterize_bwd", _BWD_ARGS),
    "rasterize_bwd_fwd": ("rasterize_bwd", _BWD_ARGS),
}
# The backward's launches (the `parts` of `launch_bwd`): the quadrant walk,
# which writes per-quadrant partial sums to a scratch, and the combine,
# which adds them in quadrant order and writes the rows.
BWD_WALK_PART, BWD_COMBINE_PART = 1, 2
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
    C, _, _ = _check_inputs(
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

    rows, scratch = bwd_buffers(gauss_ids.shape[0], C, tile_size, dev)
    launch_bwd(name, means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, livecnt, pixel_in,
               g_color, g_alpha, width, height, tile_size, rows, scratch)
    LAUNCHES[name] += 1
    return rows


def quadrants(tile_size: int) -> int:
    """16 x 16 quadrants of one kernel tile: the backward's blocks per tile."""
    return (tile_size // CONTRACT_TILE) ** 2


def bwd_buffers(num_isects: int, C: int, tile_size: int, device):
    """The backward's output rows (I, 8 + C) and its per-quadrant scratch
    (Q, I, 6 + C), both f32 and uninitialized: the combine writes every row
    (zeros for a padding slot), and the walk writes the scratch of every
    slot in a tile's range, the only slots the combine reads."""
    f32 = dict(dtype=torch.float32, device=device)
    rows = torch.empty((num_isects, GRAD_ROW_HEAD + C), **f32)
    return rows, torch.empty((quadrants(tile_size), num_isects, 6 + C), **f32)


def launch_bwd(name, means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, livecnt, pixel_in,
               g_color, g_alpha, width, height, tile_size, rows, scratch,
               parts: int = BWD_WALK_PART | BWD_COMBINE_PART):
    """Launch kernel `name`'s quadrant walk and/or combine (`parts`) on
    checked CUDA inputs and `bwd_buffers`' tensors; no launch count (the
    wrappers count whole backward calls)."""
    fn, err = _kernel(name)
    tiles_w, tiles_h = -(-width // tile_size), -(-height // tile_size)
    rc = fn(
        means2d.data_ptr(), conics.data_ptr(), opacities.data_ptr(), colors.data_ptr(),
        radii.data_ptr(), gauss_ids.data_ptr(), tile_offsets.data_ptr(),
        g_color.data_ptr(), g_alpha.data_ptr(), livecnt.data_ptr(), pixel_in.data_ptr(),
        colors.shape[1], width, height, tile_size, tiles_w, tiles_h, int(tile_size != CONTRACT_TILE),
        gauss_ids.shape[0], means2d.shape[0], rows.data_ptr(), scratch.data_ptr(), parts,
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()} (cudaError {rc})")


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


def _gather_padded(per_gauss: torch.Tensor, gauss_ids: torch.Tensor) -> torch.Tensor:
    """per_gauss[gauss_ids] with a zero row at index N: a padding slot's row."""
    pad = per_gauss.new_zeros((1,) + tuple(per_gauss.shape[1:]))
    return torch.cat([per_gauss, pad])[gauss_ids.long()]


def _slot_rows(means2d, conics, colors, opacities, gauss_ids):
    """The per-intersection rows [mx, my, ca, cb, cc, op, colors] (I, 6 + C)."""
    return _gather_padded(torch.cat([means2d, conics, opacities[:, None], colors], dim=1), gauss_ids)


def rasterize_tiles_plain(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets,
    width: int, height: int, tile_size: int,
):
    """Plain PyTorch version of `rasterize_tiles` (same inputs, same outputs)."""
    rows = _slot_rows(means2d, conics, colors, opacities, gauss_ids)
    return _composite_plain(rows, _gather_padded(radii, gauss_ids), tile_offsets, width, height, tile_size)


def rasterize_tiles_quadrants_plain(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets,
    width: int, height: int, tile_size: int,
):
    """Plain PyTorch model of the kernel's design, `rasterize_tiles`'s
    function by way of 16 x 16 quadrant blocks (`_quadrant_walk`): each
    quadrant of a tile keeps the run's slots whose contract bbox holds it
    (every slot at tile 16), compacted in run order with their ranks in the
    run, and its pixels walk only those; livecnt is the terminating slot's
    rank, or the run's length. The walk's per-pair weights, put back at
    their ranks, are summed into color and alpha as `rasterize_tiles_plain`
    sums them. Not differentiable."""
    rows = _slot_rows(means2d, conics, colors, opacities, gauss_ids)
    with torch.no_grad():
        return _composite_plain(rows, _gather_padded(radii, gauss_ids), tile_offsets, width, height, tile_size, quadrants=True)


def _composite_plain(rows, slot_radii, tile_offsets, width: int, height: int, tile_size: int, quadrants=False):
    """Composite per-intersection rows (I, 6 + C) in their (tile, depth)
    order. Tiles are taken in order of their intersection count, in batches
    whose padded (tiles, P, K_max) blocks hold at most `PLAIN_BATCH_ELEMENTS`
    pairs; each batch composites all its pairs at once with the same
    termination rule (`_dense_walk`, differentiable in `rows`, or with
    `quadrants` the kernel's quadrant design, `_quadrant_walk`)."""
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

    dt = rows.dtype
    color_t = torch.zeros((num_tiles, P, C), dtype=dt, device=dev)
    alpha_t = torch.zeros((num_tiles, P), dtype=dt, device=dev)
    live_t = torch.zeros((num_tiles, P), dtype=torch.int32, device=dev)
    tfin_t = torch.ones((num_tiles, P), dtype=dt, device=dev)

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
        walk = _quadrant_walk if quadrants else _dense_walk
        w, walked, tfin = walk(data, valid, slot_radii[slot], cnt, tiles, tiles_w, ts, gate)
        col = data[..., 6:]  # (B, K, C)
        color_t[tiles] = torch.einsum("bpk,bkc->bpc", w, col)
        alpha_t[tiles] = w.sum(-1)
        live_t[tiles] = walked
        tfin_t[tiles] = tfin

    def to_image(x):
        # (T, P, ...) tile layout -> (H, W, ...) image layout
        rest = x.shape[2:]
        x = x.reshape(tiles_h, tiles_w, ts, ts, *rest).transpose(1, 2)
        return x.reshape(tiles_h * ts, tiles_w * ts, *rest)[:height, :width].contiguous()

    return to_image(color_t), to_image(alpha_t), to_image(live_t), to_image(tfin_t)


def _pair_alphas(data, px, py):
    """sigma and alpha of every (pixel, slot) pair: data (B, K, 6 + C) slot
    rows, px / py (B, P, 1) pixel centers; (B, P, K) each."""
    gx = data[..., 0][:, None, :]  # (B, 1, K)
    gy = data[..., 1][:, None, :]
    ca = data[..., 2][:, None, :]
    cb = data[..., 3][:, None, :]
    cc = data[..., 4][:, None, :]
    op = data[..., 5][:, None, :]
    dx = gx - px  # (B, P, K)
    dy = gy - py
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    return sigma, torch.clamp(op * torch.exp(-sigma), max=MAX_ALPHA)


def _transmittance(alpha, vis):
    """(weights, inclusive transmittance, terminated) of the front-to-back
    walk over the last axis, pairs outside `vis` skipped."""
    a_eff = torch.where(vis, alpha, torch.zeros_like(alpha))
    incl_T = _sequential_cumprod(1.0 - a_eff)
    excl_T = torch.cat([torch.ones_like(incl_T[..., :1]), incl_T[..., :-1]], dim=-1)
    terminated = torch.cummax((incl_T <= TRANSMITTANCE_EPS).to(torch.int32), dim=-1).values > 0
    w = torch.where(vis & ~terminated, a_eff * excl_T, torch.zeros_like(a_eff))
    return w, incl_T, terminated


def _final_transmittance(incl_T, walked):
    """T after the last of `walked` walked positions (1 where none)."""
    last = torch.clamp(walked.long() - 1, min=0)[..., None]
    return torch.where(walked > 0, incl_T.gather(-1, last)[..., 0], torch.ones_like(incl_T[..., 0]))


def _dense_walk(data, valid, r, cnt, tiles, tiles_w: int, ts: int, gate: bool):
    """Every pixel of each tile walks the tile's whole run: (w (B, P, K),
    livecnt (B, P), t_final (B, P))."""
    del cnt
    dev, dt = data.device, data.dtype
    pix = torch.arange(ts * ts, device=dev)
    px = ((tiles % tiles_w)[:, None] * ts + pix[None, :] % ts).to(dt)[..., None] + 0.5  # (B, P, 1)
    py = ((tiles // tiles_w)[:, None] * ts + pix[None, :] // ts).to(dt)[..., None] + 0.5
    sigma, alpha = _pair_alphas(data, px, py)
    vis = valid[:, None, :] & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD)
    if gate:
        g = float(CONTRACT_TILE)
        r = r[:, None, :]
        gxd, gyd = data[..., 0].detach()[:, None, :], data[..., 1].detach()[:, None, :]
        tx = torch.floor((px - 0.5) / g)
        ty = torch.floor((py - 0.5) / g)
        vis = (
            vis
            & (tx >= torch.floor((gxd - r) / g)) & (tx < torch.ceil((gxd + r) / g))
            & (ty >= torch.floor((gyd - r) / g)) & (ty < torch.ceil((gyd + r) / g))
        )
    w, incl_T, terminated = _transmittance(alpha, vis)
    walked = (valid[:, None, :] & ~terminated).sum(-1).to(torch.int32)  # (B, P)
    return w, walked, _final_transmittance(incl_T, walked)


def _quadrant_walk(data, valid, r, cnt, tiles, tiles_w: int, ts: int, gate: bool):
    """`_dense_walk`'s outputs by the kernel's design: for each 16 x 16
    quadrant of the tiles, the slots whose contract bbox holds it (the gate,
    applied per quadrant: at tile 32 a quadrant is one contract tile),
    compacted in run order with their ranks; the quadrant's pixels walk those
    alone, livecnt is the rank of the slot that terminates them (else the
    run's length), and each weight goes back to its slot's rank."""
    dev, dt = data.device, data.dtype
    B, K = valid.shape
    side = ts // CONTRACT_TILE
    g = float(CONTRACT_TILE)
    w = torch.zeros((B, ts * ts, K), dtype=dt, device=dev)
    walked = torch.zeros((B, ts * ts), dtype=torch.int32, device=dev)
    tfin = torch.ones((B, ts * ts), dtype=dt, device=dev)
    qp = torch.arange(CONTRACT_TILE * CONTRACT_TILE, device=dev)  # a quadrant's pixels, row-major
    gx, gy = data[..., 0], data[..., 1]
    for q in range(side * side):
        qx = (tiles % tiles_w) * side + q % side  # (B,) the quadrant's contract tile
        qy = (tiles // tiles_w) * side + q // side
        passing = valid
        if gate:
            tx, ty = qx.to(dt)[:, None], qy.to(dt)[:, None]
            passing = (
                passing
                & (tx >= torch.floor((gx - r) / g)) & (tx < torch.ceil((gx + r) / g))
                & (ty >= torch.floor((gy - r) / g)) & (ty < torch.ceil((gy + r) / g))
            )
        npass = passing.sum(1)
        k_c = max(int(npass.max()), 1)
        # the passing slots first, in run order: their ranks in the run
        ranks = torch.argsort((~passing).to(torch.int8), dim=1, stable=True)[:, :k_c]  # (B, K')
        kept = torch.arange(k_c, device=dev)[None, :] < npass[:, None]
        cdata = data.gather(1, ranks[..., None].expand(-1, -1, data.shape[-1]))
        px = (qx[:, None] * CONTRACT_TILE + qp[None, :] % CONTRACT_TILE).to(dt)[..., None] + 0.5  # (B, 256, 1)
        py = (qy[:, None] * CONTRACT_TILE + qp[None, :] // CONTRACT_TILE).to(dt)[..., None] + 0.5
        sigma, alpha = _pair_alphas(cdata, px, py)
        vis = kept[:, None, :] & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD)
        wq, incl_T, terminated = _transmittance(alpha, vis)
        stop = kept[:, None, :] & terminated
        first = stop.to(torch.int32).argmax(-1)  # the first terminated compacted position
        live = torch.where(stop.any(-1), ranks.gather(1, first), cnt[:, None])
        steps = (kept[:, None, :] & ~terminated).sum(-1)  # compacted slots walked
        pix = ((q // side) * CONTRACT_TILE + qp // CONTRACT_TILE) * ts + (q % side) * CONTRACT_TILE + qp % CONTRACT_TILE
        w[:, pix] = torch.zeros((B, qp.shape[0], K), dtype=dt, device=dev).scatter(
            2, ranks[:, None, :].expand(-1, qp.shape[0], -1), wq
        )
        walked[:, pix] = live.to(torch.int32)
        tfin[:, pix] = _final_transmittance(incl_T, steps)
    return w, walked, tfin


def rasterize_tiles_bwd_plain(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, g_color, g_alpha,
    width: int, height: int, tile_size: int,
) -> torch.Tensor:
    """Plain PyTorch version of `rasterize_tiles_bwd`: autograd through the
    plain forward with respect to the gathered per-intersection rows, which
    gives each row's gradient independently of the kernel's algebra. The
    absgrad of a row is the abs of its means2d gradient (one row is one
    (tile, Gaussian) pair, so that gradient is already the tile's sum)."""
    rows = _slot_rows(means2d, conics, colors, opacities, gauss_ids).detach().requires_grad_(True)
    C = colors.shape[1]
    d_rows = None
    if rows.shape[0] > 0:
        with torch.enable_grad():
            color, alpha, _, _ = _composite_plain(
                rows, _gather_padded(radii, gauss_ids), tile_offsets, width, height, tile_size
            )
            if color.requires_grad:
                (d_rows,) = torch.autograd.grad((color, alpha), rows, (g_color, g_alpha), allow_unused=True)
    if d_rows is None:
        d_rows = torch.zeros_like(rows)
    d_rows = d_rows.detach()
    return torch.cat([d_rows[:, :6], d_rows[:, :2].abs(), d_rows[:, 6 : 6 + C]], dim=1)


def rasterize_tiles_bwd_quadrants_plain(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, g_color, g_alpha,
    width: int, height: int, tile_size: int,
) -> torch.Tensor:
    """Plain PyTorch model of the kernels' design, `rasterize_tiles_bwd`'s
    function by way of per-quadrant partials: `quadrant_partials_plain`,
    then `combine_quadrants_plain`."""
    partials = quadrant_partials_plain(
        means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, g_color, g_alpha, width, height, tile_size
    )
    return combine_quadrants_plain(partials, opacities, gauss_ids)


def quadrant_partials_plain(
    means2d, conics, colors, opacities, radii, gauss_ids, tile_offsets, g_color, g_alpha,
    width: int, height: int, tile_size: int,
) -> torch.Tensor:
    """The quadrant walk's scratch (Q, I, 6 + C): for each 16 x 16 quadrant
    of the kernel tiles (Q = 1 at tile 16, 4 at tile 32, in row-major order
    within the tile), each slot's sums over the quadrant's pixels of d means2d
    (2), d conic (3), dsigma (1) and d colors (C). Autograd through the plain
    compositor with the cotangents of the other quadrants' pixels zeroed;
    the dsigma sum is -op d opacity (d opacity = -sum dsigma / op)."""
    C = colors.shape[1]
    Q = quadrants(tile_size)
    side = tile_size // CONTRACT_TILE
    rows = _slot_rows(means2d, conics, colors, opacities, gauss_ids).detach().requires_grad_(True)
    out = torch.zeros((Q, rows.shape[0], 6 + C), dtype=torch.float32, device=means2d.device)
    if rows.shape[0] == 0:
        return out
    with torch.enable_grad():
        color, alpha, _, _ = _composite_plain(rows, _gather_padded(radii, gauss_ids), tile_offsets, width, height, tile_size)
    if not color.requires_grad:  # no pair reached any pixel
        return out
    ys = torch.arange(height, device=means2d.device)[:, None]
    xs = torch.arange(width, device=means2d.device)[None, :]
    quad = ((ys % tile_size) // CONTRACT_TILE) * side + (xs % tile_size) // CONTRACT_TILE  # (H, W)
    op = _gather_padded(opacities, gauss_ids)
    for q in range(Q):
        m = (quad == q).to(g_alpha.dtype)
        (d,) = torch.autograd.grad(
            (color, alpha), rows, (g_color * m[..., None], g_alpha * m), retain_graph=q < Q - 1, allow_unused=True
        )
        if d is None:
            continue
        d = d.detach()
        out[q, :, :5] = d[:, :5]
        out[q, :, 5] = -d[:, 5] * op
        out[q, :, 6:] = d[:, 6 : 6 + C]
    return out


def combine_quadrants_plain(partials: torch.Tensor, opacities, gauss_ids) -> torch.Tensor:
    """The combine: the Q partials (Q, I, 6 + C) added in quadrant order,
    then d opacity = -sum / op and the absgrad |sum of d means2d| over the
    whole kernel tile. Returns the rows (I, 8 + C); a padding slot
    (gauss_ids >= N) gets a zero row, whatever its partials hold."""
    s = partials[0]
    for q in range(1, partials.shape[0]):
        s = s + partials[q]
    real = (gauss_ids < opacities.shape[0])[:, None]
    s = torch.where(real, s, torch.zeros_like(s))
    op = _gather_padded(opacities, gauss_ids)
    live = (op > 0) & (s[:, 5] != 0)
    d_op = torch.where(live, -s[:, 5] / torch.where(live, op, torch.ones_like(op)), torch.zeros_like(op))
    return torch.cat([s[:, :5], d_op[:, None], s[:, :2].abs(), s[:, 6:]], dim=1)


def reduce_rows_by_gid(
    rows: torch.Tensor,  # (I, D) per-intersection rows
    gauss_ids: torch.Tensor,  # (I,) int32
    offsets: torch.Tensor,  # (N,) exclusive cumsum of counts
    counts: torch.Tensor,  # (N,) slots per Gaussian
) -> torch.Tensor:
    """Deterministic per-Gaussian sum of per-intersection rows (the twin of
    `rasterize_pallas.py:_reduce_rows_by_gid`): a stable sort by Gaussian id,
    a prefix sum, and differences at the group boundaries. Groups are
    contiguous after the sort and sized `counts`. The prefix sum runs in
    f64 (the JAX package's runs in f32): a group's difference of two f32
    prefixes would carry ~eps x |prefix| of error, which at 1e5 Gaussians
    outgrows the rows' own budget, and differs between a frame and its
    bands; in f64 each sum is its rows' sum rounded once to f32. The prefix
    sum runs along the last axis of the transposed (D, I) rows: on CUDA a
    scan over the outer axis of (I, D) is some 300x slower. The group bounds
    clamp to the slot count I, as the JAX function's do ("overflow clamps to
    the kept range"): past an overflow the expansion-order bounds run beyond
    the slots, and the padding rows they then reach (gauss_ids N, sorted
    last) are zero. Returns (N, D) f32."""
    order = torch.argsort(gauss_ids, stable=True)
    cs = torch.cumsum(rows[order].double().t().contiguous(), dim=1)  # (D, I)
    cs = torch.cat([cs.new_zeros((rows.shape[1], 1)), cs], dim=1)
    num = rows.shape[0]
    lo = torch.clamp(offsets.long(), max=num)
    hi = torch.clamp(offsets.long() + counts.long(), max=num)
    return (cs[:, hi] - cs[:, lo]).t().float()


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
    capacity: int | None = None,
):
    """Tile-rasterize pre-projected Gaussians. Returns
    (render (H, W, C), alpha (H, W, 1), num_isects). Differentiable in
    means2d, conics, colors and opacities; `means2d_sink` (N, 2), zeros,
    receives the AbsGS absgrad as its gradient (per kernel tile).
    `capacity`: bin into that many slots, with no host synchronisation
    (num_isects, the total before the clamp, is then a 0-d device tensor),
    and with ELLIPSE_CULL the conics and opacities cull the bins; None bins
    exactly num_isects slots (an int)."""
    cull = ELLIPSE_CULL and capacity is not None
    isect = build_intersections(
        means2d.detach(), radii, depths.detach(), width, height, tile_size, capacity,
        conics=conics if cull else None, opacities=opacities if cull else None, precull=PRECULL,
    )
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
