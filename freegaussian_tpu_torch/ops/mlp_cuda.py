"""The field MLPs: CUDA kernel wrappers and their plain PyTorch versions.

Three differentiable functions share one kernel pair (`csrc/deform_field.cu`):

- `deform_field(x, t_row, ws, bs, head_w, head_b)` runs the whole deform
  field (the NeRF embedding of x, the 8x256 bf16 ReLU trunk with its skip,
  the 13 packed f32 head lanes) for one shared time row, the port of the TPU
  kernels `freegaussian_tpu/ops/mlp_pallas.py:_fused_field_heads_fwd` /
  `_fused_field_heads_bwd`. Its forward is `deform_field_fwd`, its backward
  `deform_field_bwd`.
- `field_trunk(x, value, t_row, ws, bs)` runs the embedding of one source
  (x, plus a shared time row: the deform trunk) or two (x and a per-point
  control value: the control trunk) and the trunk, and returns the last
  activation; the caller runs its heads in f32. It is the port of
  `mlp_pallas.py:_fused_field_fwd` / `_fused_field_bwd`, which
  `fused_deform_trunk` and `fused_control_trunk` reach. Its forward is
  `field_trunk_fwd`, its backward `field_trunk_bwd`.
- `fused_trunk(x_emb, t_emb, ws, bs)` runs the trunk alone on a precomputed
  embedding [x_emb | t_emb | 0] (128 f32 lanes, rounded to bf16 in the
  kernel), the port of `mlp_pallas.py:fused_trunk` (TPU kernels
  `_pallas_fwd` / `_fused_trunk_bwd`), which the deform field reaches for
  per-point times. Its forward is `trunk_fwd`, its backward `trunk_bwd`,
  which stops at d emb (N, 128): autograd carries it into x_emb and t_emb.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version, which computes the same function with the same
rounding points: bf16 product operands with f32 accumulation, f32 bias and
ReLU, bf16-stored activations, f32 heads; the backward's products take
bf16(g).

Live rows. Each of the three takes `live`, an (N,) bool mask on the data's
device (the Gaussians' `alive`), or None for every row. With a mask only the
128-row blocks that hold a live row do work: their rows, dead ones included,
are bit-equal to the `live=None` call in the outputs and the data gradients
(dx, d emb); every row of a block with no live row is zero in what the
caller reads (y, or h: the last saved activation in training) and in dx;
the weight and bias gradients sum the live blocks' rows alone (deterministic,
and within the gradient budget of the `None` call, whose sums are split
elsewhere). That is exact for a caller whose cotangents are zero on dead
rows, as every consumer of the fields masks by `alive`. The kernels take the
mask as a device block list (`live_blocks`), made once in a forward and kept
for its backward, with no host synchronisation, so CUDA graphs capture it
and a replay reads the mask as it is then.

Embedding lanes (128): source s takes lanes [s X, (s + 1) X), X = 3 (1 + 2 L)
in `positional_embed`'s order; the time row follows the sources; the rest is
zero. The trunk weights travel packed (`pack_trunk`): layer i as a (256, K_i)
bf16 row-major block, K_0 = 128 (the embedding lanes, zero padded), K_5 =
128 + 256 (the skip), 256 otherwise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .math import positional_embed

H = 256  # trunk width
DEPTH = 8
SKIP_IN = 5  # the layer that takes [emb | h_4]
EMB = 128  # embedding lanes: the source lanes, the time lanes, zero padding
MAX_SOURCES = 2
NOUT = 13  # packed head lanes: w (3) | v (3) | rotation (4) | scaling (3)
# Rows of one forward or data-gradient block; row counts are padded to a multiple.
ROWS = 128
# Shares of the rows over which the weight-gradient kernel splits its sums
# (the wrapper adds the shares in order): 16 tiles x 8 shares, one block an
# SM, one wave on 132 SMs. Each share is a multiple of WGRAD_CHUNK rows.
WGRAD_SPLITS = 8
WGRAD_CHUNK = 64
WGRAD_TILE_K = 128  # input columns of one weight-gradient tile (all 256 outputs)
# Each data-gradient block's f32 sums, one row of a scratch the wrapper adds
# in a fixed order: d bias (8, 256), d head_w (13, 256), d head_b (13,), the
# row sum of d emb (128,).
SMALL_DHW = DEPTH * H
SMALL_DHB = SMALL_DHW + NOUT * H
SMALL_DEMB = SMALL_DHB + NOUT
SMALL = SMALL_DEMB + EMB
# The backward's launches (the `parts` of `launch_bwd`): the data-gradient
# walk, and the weight-gradient pass that reads its G.
DGRAD_PART, WGRAD_PART = 1, 2

# Kernel launches by kernel name. Each wrapper adds one where it launches its
# kernel and nowhere else; `chip_smoke.py` zeroes and reads it.
LAUNCHES = {"deform_fwd": 0, "deform_bwd": 0, "field_fwd": 0, "field_bwd": 0, "trunk_fwd": 0, "trunk_bwd": 0}
# The CUDA sources (csrc/<name>.cu) this module launches.
KERNEL_SOURCES = ("deform_field",)

_fns: dict = {}


def layer_k(i: int) -> int:
    return EMB if i == 0 else (EMB + H if i == SKIP_IN else H)


def _layer_offsets():
    offs = [0]
    for i in range(DEPTH):
        offs.append(offs[-1] + H * layer_k(i))
    return offs


OFFSETS = _layer_offsets()  # OFFSETS[i]: start of layer i in the packed weights; [-1]: their size


def _kernel(name: str):
    """(entry point, error-string function) of `name` in `csrc/deform_field.cu`."""
    if name not in _fns:
        from ..cuda_build import load

        lib = load("deform_field")
        fn = getattr(lib, name)
        I, P = ctypes.c_int, ctypes.c_void_p
        if name == "field_fwd":
            fn.argtypes = [I, P, I, I, I, P, I] + [P] * 7 + [I] + [P] * 3
        else:
            fn.argtypes = [I, P, I, I, I] + [P] * 5 + [I, I] + [P] * 4 + [I] + [P] * 3
        fn.restype = ctypes.c_int
        size = lib.field_packed_size
        size.restype = ctypes.c_long
        if size() != OFFSETS[-1]:
            raise RuntimeError(f"deform_field.cu packs {size()} weights, this module {OFFSETS[-1]}")
        if lib.field_bwd_rows() != ROWS or lib.field_bwd_small() != SMALL:
            raise RuntimeError("deform_field.cu's backward block or sums differ from this module's")
        err = lib.field_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[name] = (fn, err)
    return _fns[name]


def _padded_rows(n: int) -> int:
    return max(-(-n // ROWS), 1) * ROWS


def _block_flags(live: torch.Tensor) -> torch.Tensor:
    """(N_pad / ROWS,) bool: the 128-row block holds a live row."""
    rows = torch.zeros(_padded_rows(live.shape[0]), dtype=torch.bool, device=live.device)
    rows[: live.shape[0]] = live
    return rows.view(-1, ROWS).any(1)


def live_blocks(live: torch.Tensor) -> torch.Tensor:
    """The kernels' block list of the (N,) bool mask `live`: (B + 1,) int32
    on its device, B = N_pad / ROWS. Entries [0, B) are a stable partition of
    the block indices, the blocks that hold a live row first in row order,
    then the others; entry B is the live count. Static-shape operations only
    (cumsum and scatter, no host synchronisation)."""
    flags = _block_flags(live)
    f = flags.to(torch.int32)
    live_rank = torch.cumsum(f, 0, dtype=torch.int32)
    count = live_rank[-1:]
    dead_rank = torch.cumsum(1 - f, 0, dtype=torch.int32) + count
    pos = (torch.where(flags, live_rank, dead_rank) - 1).long()
    order = torch.empty_like(f).scatter_(0, pos, torch.arange(f.shape[0], dtype=torch.int32, device=f.device))
    return torch.cat([order, count])


def _live_block_rows(live: torch.Tensor) -> torch.Tensor:
    """(N_pad,) bool: the row's 128-row block holds a live row."""
    return _block_flags(live)[:, None].expand(-1, ROWS).reshape(-1)


def _blocks_for(live: Optional[torch.Tensor], blocks: Optional[torch.Tensor], n: int, device):
    """Checks `live` against the data (N rows on `device`); returns the
    block list the kernels launch with: None without a mask or on the CPU
    (the plain versions read the mask), else `blocks` (the caller's
    `live_blocks(live)`, made once for a forward and its backward) or one
    made here."""
    if live is None:
        return None
    _check("live", live, torch.bool, device, (n,))
    if device.type != "cuda":
        return None
    if blocks is None:
        return live_blocks(live)
    _check("blocks", blocks, torch.int32, device, (_padded_rows(n) // ROWS + 1,))
    return blocks


def _block_args(blocks: Optional[torch.Tensor]):
    """(block list, live count) device pointers, or (None, None)."""
    if blocks is None:
        return None, None
    return blocks.data_ptr(), blocks[-1:].data_ptr()


def _check(name, t, dtype, device, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_lanes(sources: int, x_lanes: int, t_lanes: int):
    if (
        not 1 <= sources <= MAX_SOURCES
        or x_lanes < 3 or x_lanes % 3 or (x_lanes // 3) % 2 != 1
        or sources * x_lanes + t_lanes > EMB
    ):
        raise ValueError(
            f"the field takes 1-{MAX_SOURCES} sources of 3 (1 + 2 L) lanes and at most {EMB} lanes, "
            f"got {sources} x {x_lanes} + {t_lanes}"
        )


def _device_kind(dev: torch.device) -> str:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the field kernels run on cuda or cpu tensors, got {dev}")
    return dev.type


def pack_trunk(ws, in_ch: int) -> torch.Tensor:
    """The eight trunk weights (torch layout (256, fan_in)) as one bf16 vector:
    layer 0's input columns and layer 5's embedding columns padded to 128."""
    parts = []
    for i, w in enumerate(ws):
        w = w.to(torch.bfloat16)
        if i == 0:
            w = torch.nn.functional.pad(w, (0, EMB - in_ch))
        elif i == SKIP_IN:
            w = torch.cat([torch.nn.functional.pad(w[:, :in_ch], (0, EMB - in_ch)), w[:, in_ch:]], dim=1)
        parts.append(w.reshape(-1))
    return torch.cat(parts).contiguous()


def unpack_trunk(packed: torch.Tensor, in_ch: int):
    """`pack_trunk`'s inverse for a packed gradient: eight (256, fan_in) tensors."""
    ws = []
    for i in range(DEPTH):
        w = packed[OFFSETS[i] : OFFSETS[i + 1]].view(H, layer_k(i))
        if i == 0:
            w = w[:, :in_ch]
        elif i == SKIP_IN:
            w = torch.cat([w[:, :in_ch], w[:, EMB:]], dim=1)
        ws.append(w.contiguous())
    return ws


def _layer(packed: torch.Tensor, i: int) -> torch.Tensor:
    return packed[OFFSETS[i] : OFFSETS[i + 1]].view(H, layer_k(i))


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# the kernels' launches
# ---------------------------------------------------------------------------


def _launch_fwd(heads, x, t_row, wpack, bias, head_w, head_b, sources, x_lanes, out, save, blocks=None):
    """One `field_fwd` launch. Returns the saved (emb, acts), or None. `out`
    may be None for the trunk alone with `save`: h is then acts[-1, :N].
    `blocks`: the `live_blocks` of the call's mask, or None (every row)."""
    dev = x.device
    n = x.shape[0]
    n_pad = _padded_rows(n)
    emb = acts = None
    if save:
        emb = torch.empty((n_pad, EMB), dtype=torch.bfloat16, device=dev)
        acts = torch.empty((DEPTH, n_pad, H), dtype=torch.bfloat16, device=dev)
    fn, err = _kernel("field_fwd")
    rc = fn(
        int(heads), x.data_ptr(), n, sources, x_lanes, t_row.data_ptr(), t_row.shape[0], wpack.data_ptr(),
        bias.data_ptr(), head_w.data_ptr() if heads else None, head_b.data_ptr() if heads else None,
        out.data_ptr() if out is not None else None, emb.data_ptr() if save else None,
        acts.data_ptr() if save else None, n_pad, *_block_args(blocks),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"field_fwd launch failed: {err(rc).decode()} (cudaError {rc})")
    return (emb, acts) if save else None


def bwd_buffers(n: int, sources: int, device) -> dict:
    """The backward's outputs and scratch, uninitialized (the kernels write
    every element): G (8, N_pad, 256) bf16, each layer's bf16(g); small
    (N_pad / ROWS, SMALL) f32, each data-gradient block's sums; dx (N, 3 S),
    or d emb (N, 128) without sources; partial (splits, packed size) f32,
    each share of the rows' weight gradients."""
    n_pad = _padded_rows(n)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "G": torch.empty((DEPTH, n_pad, H), dtype=torch.bfloat16, device=device),
        "small": torch.empty((n_pad // ROWS, SMALL), **f32),
        "dx": torch.empty((n, 3 * sources if sources else EMB), **f32),
        "partial": torch.empty((max(1, min(WGRAD_SPLITS, n_pad // WGRAD_CHUNK)), OFFSETS[-1]), **f32),
    }


def launch_bwd(heads, x, dout, wpack, head_w, emb, acts, sources, x_lanes, bufs: dict,
               parts: int = DGRAD_PART | WGRAD_PART, blocks=None):
    """Launch `field_bwd`'s data-gradient walk and/or weight-gradient pass
    (`parts`) on checked CUDA inputs and `bwd_buffers`' tensors, with the
    forward's `blocks` (or None); no launch count (the wrappers count whole
    backward calls)."""
    n = dout.shape[0]
    fn, err = _kernel("field_bwd")
    rc = fn(
        int(heads), x.data_ptr() if x is not None else None, n, sources, x_lanes, dout.data_ptr(), wpack.data_ptr(),
        head_w.data_ptr() if heads else None, emb.data_ptr(), acts.data_ptr(), _padded_rows(n),
        bufs["partial"].shape[0], bufs["G"].data_ptr(), bufs["small"].data_ptr(), bufs["dx"].data_ptr(),
        bufs["partial"].data_ptr(), parts, *_block_args(blocks), torch.cuda.current_stream(dout.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"field_bwd launch failed: {err(rc).decode()} (cudaError {rc})")


def _launch_bwd(heads, x, dout, wpack, head_w, emb, acts, sources, x_lanes, blocks=None):
    """One `field_bwd` call (data-gradient walk, then weight-gradient
    tiles); the per-block sums and the shares of the weight gradients are
    added in a fixed order. Returns (dx, d emb row sum, packed dW, d bias,
    d head_w, d head_b), the last two None without heads; without sources
    (x None) dx is d emb (N, 128). `blocks`: the forward's, or None."""
    bufs = bwd_buffers(dout.shape[0], sources, dout.device)
    launch_bwd(heads, x, dout, wpack, head_w, emb, acts, sources, x_lanes, bufs, blocks=blocks)
    sums = bufs["small"].sum(0)
    dbias = sums[:SMALL_DHW].view(DEPTH, H)
    dhw = sums[SMALL_DHW:SMALL_DHB].view(NOUT, H) if heads else None
    dhb = sums[SMALL_DHB:SMALL_DEMB] if heads else None
    return bufs["dx"], sums[SMALL_DEMB:], bufs["partial"].sum(0), dbias, dhw, dhb


# ---------------------------------------------------------------------------
# plain versions of the shared parts
# ---------------------------------------------------------------------------


def _embed_plain(xsrc: torch.Tensor, t_row: torch.Tensor, sources: int, x_lanes: int, n_pad: int) -> torch.Tensor:
    """The (N_pad, 128) bf16 embedding rows, x = 0 on the padded rows."""
    xp = torch.zeros((n_pad, 3 * sources), dtype=torch.float32, device=xsrc.device)
    xp[: xsrc.shape[0]] = xsrc
    emb = torch.zeros((n_pad, EMB), dtype=torch.float32, device=xsrc.device)
    num_freqs = (x_lanes // 3 - 1) // 2
    for s in range(sources):
        emb[:, s * x_lanes : (s + 1) * x_lanes] = positional_embed(xp[:, 3 * s : 3 * s + 3], num_freqs)
    lanes = sources * x_lanes
    emb[:, lanes : lanes + t_row.shape[0]] = t_row
    return emb.to(torch.bfloat16)


def _trunk_fwd_plain(emb: torch.Tensor, wpack: torch.Tensor, bias: torch.Tensor):
    """The eight bf16 activations (each (N_pad, 256), f32 tensors of bf16 values)."""
    e = emb.float()
    h = None
    acts = []
    for i in range(DEPTH):
        inp = e if i == 0 else (torch.cat([e, h], dim=1) if i == SKIP_IN else h)
        z = inp @ _layer(wpack, i).float().t() + bias[i]
        h = _bf16_values(torch.relu(z))
        acts.append(h)
    return acts


def _trunk_bwd_plain(g: torch.Tensor, wpack: torch.Tensor, a, e: torch.Tensor):
    """From g = dL/dz_7 (the top layer's masked gradient), the walk down the
    trunk: (d emb (N, 128), the packed dW, d bias (8, 256))."""
    dbias = [None] * DEPTH
    dws = [None] * DEPTH
    d_emb = None
    for i in range(DEPTH - 1, -1, -1):
        dbias[i] = g.sum(0)
        gb = _bf16_values(g)
        inp = e if i == 0 else (torch.cat([e, a[i - 1]], dim=1) if i == SKIP_IN else a[i - 1])
        dws[i] = gb.t() @ inp
        d_in = gb @ _layer(wpack, i).float()
        if i == 0:
            d_emb = d_in if d_emb is None else d_in + d_emb
        elif i == SKIP_IN:
            d_emb = d_in[:, :EMB]
            g = d_in[:, EMB:] * (a[i - 1] > 0)
        else:
            g = d_in * (a[i - 1] > 0)
    return d_emb, torch.cat([w.reshape(-1) for w in dws]), torch.stack(dbias)


def _dead_rows_zero(t: torch.Tensor, live: Optional[torch.Tensor]) -> torch.Tensor:
    """`t`, whose rows are the field's (N or N_pad of them), with zeros on
    the rows of the blocks with no live row, as the kernels write them."""
    if live is None:
        return t
    return torch.where(_live_block_rows(live)[: t.shape[0], None], t, t.new_zeros(()))


def _bwd_rows_plain(dout, acts, emb, live: Optional[torch.Tensor]):
    """The backward's f32 rows of the field's N rows (dout, the eight
    activations, the embedding), zero on the blocks with no live row, whose
    saved rows the kernels leave unwritten."""
    n = dout.shape[0]
    a = [_dead_rows_zero(acts[i, :n].float(), live) for i in range(DEPTH)]
    return _dead_rows_zero(dout, live), a, _dead_rows_zero(emb[:n].float(), live)


def _embed_bwd_plain(xsrc: torch.Tensor, d_emb: torch.Tensor, sources: int, x_lanes: int) -> torch.Tensor:
    """dx (N, 3 S) through the embedding: lane (s, b, c) is x_sc, sin(f x_sc)
    or cos(f x_sc)."""
    parts = []
    for s in range(sources):
        x = xsrc[:, 3 * s : 3 * s + 3]
        d = d_emb[:, s * x_lanes : (s + 1) * x_lanes]
        dx = d[:, 0:3].clone()
        for b in range(1, x_lanes // 3):
            f = float(2 ** ((b - 1) // 2))
            sc = x * f
            deriv = torch.cos(sc) if b % 2 else -torch.sin(sc)
            dx = dx + d[:, 3 * b : 3 * b + 3] * deriv * f
        parts.append(dx)
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# the deform field with its heads
# ---------------------------------------------------------------------------


def deform_field_fwd(
    x: torch.Tensor,  # (N, 3) f32
    t_row: torch.Tensor,  # (t_lanes,) f32 shared time row
    wpack: torch.Tensor,  # packed trunk weights, bf16
    bias: torch.Tensor,  # (8, 256) f32
    head_w: torch.Tensor,  # (13, 256) f32
    head_b: torch.Tensor,  # (13,) f32
    x_lanes: int,
    save: bool,
    live: Optional[torch.Tensor] = None,  # (N,) bool, or None: every row
    blocks: Optional[torch.Tensor] = None,  # live_blocks(live), or None: made here
):
    """Returns y (N, 13) f32 and, with `save`, the backward's inputs: the
    bf16 embedding (N_pad, 128) and activations (8, N_pad, 256), rows padded
    to a multiple of 128 (the padded rows hold x = 0). With `live`, y is
    zero on the blocks with no live row, whose saved rows are not written."""
    n = x.shape[0]
    dev = x.device
    _check_lanes(1, x_lanes, t_row.shape[0])
    for name, t, dt, shape in (
        ("x", x, torch.float32, (n, 3)),
        ("t_row", t_row, torch.float32, (t_row.shape[0],)),
        ("wpack", wpack, torch.bfloat16, (OFFSETS[-1],)),
        ("bias", bias, torch.float32, (DEPTH, H)),
        ("head_w", head_w, torch.float32, (NOUT, H)),
        ("head_b", head_b, torch.float32, (NOUT,)),
    ):
        _check(name, t, dt, dev, shape)
    blocks = _blocks_for(live, blocks, n, dev)
    if _device_kind(dev) == "cpu":
        return deform_field_fwd_plain(x, t_row, wpack, bias, head_w, head_b, x_lanes, save, live)
    y = torch.empty((n, NOUT), dtype=torch.float32, device=dev)
    saved = _launch_fwd(True, x, t_row, wpack, bias, head_w, head_b, 1, x_lanes, y, save, blocks)
    LAUNCHES["deform_fwd"] += 1
    return y, saved


def deform_field_fwd_plain(x, t_row, wpack, bias, head_w, head_b, x_lanes: int, save: bool, live=None):
    """Plain PyTorch version of `deform_field_fwd` (same inputs, same outputs)."""
    n = x.shape[0]
    emb = _embed_plain(x, t_row, 1, x_lanes, _padded_rows(n))
    acts = _trunk_fwd_plain(emb, wpack, bias)
    y = _dead_rows_zero((acts[-1][:n] @ head_w.t() + head_b).contiguous(), live)
    return y, ((emb, torch.stack(acts).to(torch.bfloat16)) if save else None)


def deform_field_bwd(
    x: torch.Tensor,  # (N, 3) f32
    dy: torch.Tensor,  # (N, 13) f32
    wpack: torch.Tensor,
    head_w: torch.Tensor,
    emb: torch.Tensor,  # (N_pad, 128) bf16, from the forward
    acts: torch.Tensor,  # (8, N_pad, 256) bf16, from the forward
    x_lanes: int,
    live: Optional[torch.Tensor] = None,  # the forward's
    blocks: Optional[torch.Tensor] = None,  # the forward's live_blocks(live), or None: made here
):
    """Returns (dx (N, 3), the row sum of d emb (128,), the packed trunk
    weight gradient (f32), d bias (8, 256), d head_w (13, 256), d head_b (13,)).
    With `live`, dx is zero on the blocks with no live row, and the sums
    run over the others."""
    n = x.shape[0]
    n_pad = _padded_rows(n)
    dev = x.device
    _check_lanes(1, x_lanes, 0)
    for name, t, dt, shape in (
        ("x", x, torch.float32, (n, 3)),
        ("dy", dy, torch.float32, (n, NOUT)),
        ("wpack", wpack, torch.bfloat16, (OFFSETS[-1],)),
        ("head_w", head_w, torch.float32, (NOUT, H)),
        ("emb", emb, torch.bfloat16, (n_pad, EMB)),
        ("acts", acts, torch.bfloat16, (DEPTH, n_pad, H)),
    ):
        _check(name, t, dt, dev, shape)
    blocks = _blocks_for(live, blocks, n, dev)
    if _device_kind(dev) == "cpu":
        return deform_field_bwd_plain(x, dy, wpack, head_w, emb, acts, x_lanes, live)
    out = _launch_bwd(True, x, dy, wpack, head_w, emb, acts, 1, x_lanes, blocks)
    LAUNCHES["deform_bwd"] += 1
    return out


def deform_field_bwd_plain(x, dy, wpack, head_w, emb, acts, x_lanes: int, live=None):
    """Plain PyTorch version of `deform_field_bwd` (same inputs, same outputs)."""
    dy, a, e = _bwd_rows_plain(dy, acts, emb, live)
    dhb = dy.sum(0)
    dhw = dy.t() @ a[DEPTH - 1]
    g = (dy @ head_w) * (a[DEPTH - 1] > 0)
    d_emb, dpack, dbias = _trunk_bwd_plain(g, wpack, a, e)
    return _dead_rows_zero(_embed_bwd_plain(x, d_emb, 1, x_lanes), live), d_emb.sum(0), dpack, dbias, dhw, dhb


class _DeformFieldFn(torch.autograd.Function):
    """Forward `deform_field_fwd`, backward `deform_field_bwd`; gradients in
    f32 for x, the time row and every master weight."""

    @staticmethod
    def forward(ctx, save, live, x, t_row, head_w, head_b, *trunk):
        ws, bs = trunk[:DEPTH], trunk[DEPTH:]
        in_ch = ws[0].shape[1]
        x_lanes = in_ch - t_row.shape[0]
        wpack = pack_trunk(ws, in_ch)
        bias = torch.stack([b.float() for b in bs]).contiguous()
        blocks = _blocks_for(live, None, x.shape[0], x.device)
        y, saved = deform_field_fwd(x, t_row, wpack, bias, head_w, head_b, x_lanes, save, live, blocks)
        if save:
            ctx.save_for_backward(x, wpack, head_w, *saved, live, blocks)
            ctx.dims = (in_ch, x_lanes, t_row.shape[0])
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wpack, head_w, emb, acts, live, blocks = ctx.saved_tensors
        in_ch, x_lanes, t_lanes = ctx.dims
        dx, demb, dpack, dbias, dhw, dhb = deform_field_bwd(
            x, dy.float().contiguous(), wpack, head_w, emb, acts, x_lanes, live, blocks
        )
        return (
            None, None, dx, demb[x_lanes : x_lanes + t_lanes], dhw, dhb, *unpack_trunk(dpack, in_ch),
            *dbias.unbind(0),
        )


def _check_trunk(ws, bs):
    if len(ws) != DEPTH or len(bs) != DEPTH or ws[1].shape != (H, H):
        raise ValueError(f"the fused field is {DEPTH} layers of {H}")


def deform_field(x, t_row, ws, bs, head_w, head_b, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused deform field: x (N, 3), t_row (t_lanes,) the shared time
    embedding, ws / bs the eight trunk layers (torch layout: (256, fan_in),
    fan_in = x lanes + t lanes for layers 0 and 5's leading columns),
    head_w (13, 256) and head_b (13,) the packed heads, `live` (N,) bool or
    None (the module docstring's live rows). Returns (N, 13) f32."""
    _check_trunk(ws, bs)
    inputs = (x, t_row, head_w, head_b, *ws, *bs)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    return _DeformFieldFn.apply(
        save, live, x.float().contiguous(), t_row.float().contiguous(), head_w.float().contiguous(),
        head_b.float().contiguous(), *ws, *bs,
    )


# ---------------------------------------------------------------------------
# the trunk alone (deform trunk, control trunk)
# ---------------------------------------------------------------------------


def field_trunk_fwd(
    xsrc: torch.Tensor,  # (N, 3 S) f32: the S sources side by side
    t_row: torch.Tensor,  # (t_lanes,) f32 shared time row (may be empty)
    wpack: torch.Tensor,  # packed trunk weights, bf16
    bias: torch.Tensor,  # (8, 256) f32
    sources: int,
    x_lanes: int,  # embedding lanes of one source
    save: bool,
    live: Optional[torch.Tensor] = None,  # (N,) bool, or None: every row
    blocks: Optional[torch.Tensor] = None,  # live_blocks(live), or None: made here
):
    """Returns h (N, 256) bf16, the trunk's last activation, and with `save`
    the backward's inputs: the bf16 embedding (N_pad, 128) and activations
    (8, N_pad, 256), rows padded to a multiple of 128 (the padded rows hold
    x = 0). With `save`, h is a view of the last activation, written once.
    With `live`, h is zero on the blocks with no live row, whose other saved
    rows are not written."""
    n = xsrc.shape[0]
    dev = xsrc.device
    _check_lanes(sources, x_lanes, t_row.shape[0])
    for name, t, dt, shape in (
        ("xsrc", xsrc, torch.float32, (n, 3 * sources)),
        ("t_row", t_row, torch.float32, (t_row.shape[0],)),
        ("wpack", wpack, torch.bfloat16, (OFFSETS[-1],)),
        ("bias", bias, torch.float32, (DEPTH, H)),
    ):
        _check(name, t, dt, dev, shape)
    blocks = _blocks_for(live, blocks, n, dev)
    if _device_kind(dev) == "cpu":
        return field_trunk_fwd_plain(xsrc, t_row, wpack, bias, sources, x_lanes, save, live)
    h = None if save else torch.empty((n, H), dtype=torch.bfloat16, device=dev)
    saved = _launch_fwd(False, xsrc, t_row, wpack, bias, None, None, sources, x_lanes, h, save, blocks)
    LAUNCHES["field_fwd"] += 1
    return (saved[1][-1, :n] if save else h), saved


def field_trunk_fwd_plain(xsrc, t_row, wpack, bias, sources: int, x_lanes: int, save: bool, live=None):
    """Plain PyTorch version of `field_trunk_fwd` (same inputs, same outputs)."""
    n = xsrc.shape[0]
    emb = _embed_plain(xsrc, t_row, sources, x_lanes, _padded_rows(n))
    acts = torch.stack(_trunk_fwd_plain(emb, wpack, bias)).to(torch.bfloat16)
    acts[-1] = _dead_rows_zero(acts[-1], live)
    return (acts[-1, :n], (emb, acts)) if save else (acts[-1, :n].clone(), None)


def field_trunk_bwd(
    xsrc: torch.Tensor,  # (N, 3 S) f32
    dh: torch.Tensor,  # (N, 256) f32
    wpack: torch.Tensor,
    emb: torch.Tensor,  # (N_pad, 128) bf16, from the forward
    acts: torch.Tensor,  # (8, N_pad, 256) bf16, from the forward
    sources: int,
    x_lanes: int,
    live: Optional[torch.Tensor] = None,  # the forward's
    blocks: Optional[torch.Tensor] = None,  # the forward's live_blocks(live), or None: made here
):
    """Returns (dxsrc (N, 3 S), the row sum of d emb (128,), the packed trunk
    weight gradient (f32), d bias (8, 256)). With `live`, dxsrc is zero on
    the blocks with no live row, and the sums run over the others."""
    n = xsrc.shape[0]
    n_pad = _padded_rows(n)
    dev = xsrc.device
    _check_lanes(sources, x_lanes, 0)
    for name, t, dt, shape in (
        ("xsrc", xsrc, torch.float32, (n, 3 * sources)),
        ("dh", dh, torch.float32, (n, H)),
        ("wpack", wpack, torch.bfloat16, (OFFSETS[-1],)),
        ("emb", emb, torch.bfloat16, (n_pad, EMB)),
        ("acts", acts, torch.bfloat16, (DEPTH, n_pad, H)),
    ):
        _check(name, t, dt, dev, shape)
    blocks = _blocks_for(live, blocks, n, dev)
    if _device_kind(dev) == "cpu":
        return field_trunk_bwd_plain(xsrc, dh, wpack, emb, acts, sources, x_lanes, live)
    dx, demb, dpack, dbias, _, _ = _launch_bwd(False, xsrc, dh, wpack, None, emb, acts, sources, x_lanes, blocks)
    LAUNCHES["field_bwd"] += 1
    return dx, demb, dpack, dbias


def field_trunk_bwd_plain(xsrc, dh, wpack, emb, acts, sources: int, x_lanes: int, live=None):
    """Plain PyTorch version of `field_trunk_bwd` (same inputs, same outputs)."""
    dh, a, e = _bwd_rows_plain(dh, acts, emb, live)
    g = dh * (a[DEPTH - 1] > 0)
    d_emb, dpack, dbias = _trunk_bwd_plain(g, wpack, a, e)
    return _dead_rows_zero(_embed_bwd_plain(xsrc, d_emb, sources, x_lanes), live), d_emb.sum(0), dpack, dbias


class _FieldTrunkFn(torch.autograd.Function):
    """Forward `field_trunk_fwd`, backward `field_trunk_bwd`. The output is
    the bf16 activation, so autograd hands the backward a bf16 cotangent, as
    the JAX package's cast of the trunk output to f32 does."""

    @staticmethod
    def forward(ctx, save, sources, live, xsrc, t_row, *trunk):
        ws, bs = trunk[:DEPTH], trunk[DEPTH:]
        in_ch = ws[0].shape[1]
        x_lanes = (in_ch - t_row.shape[0]) // sources
        wpack = pack_trunk(ws, in_ch)
        bias = torch.stack([b.float() for b in bs]).contiguous()
        blocks = _blocks_for(live, None, xsrc.shape[0], xsrc.device)
        h, saved = field_trunk_fwd(xsrc, t_row, wpack, bias, sources, x_lanes, save, live, blocks)
        if save:
            ctx.save_for_backward(xsrc, wpack, *saved, live, blocks)
            ctx.dims = (in_ch, sources, x_lanes, t_row.shape[0])
        return h

    @staticmethod
    def backward(ctx, dh):
        xsrc, wpack, emb, acts, live, blocks = ctx.saved_tensors
        in_ch, sources, x_lanes, t_lanes = ctx.dims
        dx, demb, dpack, dbias = field_trunk_bwd(
            xsrc, dh.float().contiguous(), wpack, emb, acts, sources, x_lanes, live, blocks
        )
        lanes = sources * x_lanes
        return None, None, None, dx, demb[lanes : lanes + t_lanes], *unpack_trunk(dpack, in_ch), *dbias.unbind(0)


def field_trunk(
    x: torch.Tensor, value: Optional[torch.Tensor], t_row: Optional[torch.Tensor], ws, bs,
    live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused field trunk: the embedding of x (N, 3) and, for the control
    field, of the per-point value (N, 3), plus the shared time row t_row
    (t_lanes,) for the deform field; ws / bs the eight trunk layers (torch
    layout: (256, fan_in), fan_in = the embedding lanes for layers 0 and 5's
    leading columns); `live` (N,) bool or None (the module docstring's live
    rows). Returns the last activation (N, 256), f32 holding bf16 values;
    differentiable in x, value, t_row and every weight."""
    _check_trunk(ws, bs)
    srcs = [x] if value is None else [x, value]
    xsrc = torch.cat([s.float() for s in srcs], dim=1).contiguous()
    if t_row is None:
        t_row = x.new_zeros((0,), dtype=torch.float32)
    inputs = (*srcs, t_row, *ws, *bs)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    h = _FieldTrunkFn.apply(save, len(srcs), live, xsrc, t_row.float().contiguous(), *ws, *bs)
    return h.float()


# ---------------------------------------------------------------------------
# the trunk on a precomputed embedding (per-point times)
# ---------------------------------------------------------------------------


def trunk_fwd(
    inp: torch.Tensor,  # (N, 128) f32 embedding [x_emb | t_emb | 0]
    wpack: torch.Tensor,  # packed trunk weights, bf16
    bias: torch.Tensor,  # (8, 256) f32
    save: bool,
    live: Optional[torch.Tensor] = None,  # (N,) bool, or None: every row
    blocks: Optional[torch.Tensor] = None,  # live_blocks(live), or None: made here
):
    """Returns h (N, 256) bf16, the trunk's last activation, and with `save`
    the backward's inputs: the bf16 embedding (N_pad, 128) and activations
    (8, N_pad, 256), rows padded to a multiple of 128 (zero embedding rows).
    With `save`, h is a view of the last activation, written once. With
    `live`, h is zero on the blocks with no live row, whose other saved rows
    are not written."""
    n = inp.shape[0]
    dev = inp.device
    for name, t, dt, shape in (
        ("inp", inp, torch.float32, (n, EMB)),
        ("wpack", wpack, torch.bfloat16, (OFFSETS[-1],)),
        ("bias", bias, torch.float32, (DEPTH, H)),
    ):
        _check(name, t, dt, dev, shape)
    blocks = _blocks_for(live, blocks, n, dev)
    if _device_kind(dev) == "cpu":
        return trunk_fwd_plain(inp, wpack, bias, save, live)
    h = None if save else torch.empty((n, H), dtype=torch.bfloat16, device=dev)
    no_row = inp.new_zeros((0,))
    saved = _launch_fwd(False, inp, no_row, wpack, bias, None, None, 0, 0, h, save, blocks)
    LAUNCHES["trunk_fwd"] += 1
    return (saved[1][-1, :n] if save else h), saved


def trunk_fwd_plain(inp, wpack, bias, save: bool, live=None):
    """Plain PyTorch version of `trunk_fwd` (same inputs, same outputs)."""
    n = inp.shape[0]
    emb = torch.zeros((_padded_rows(n), EMB), dtype=torch.float32, device=inp.device)
    emb[:n] = inp
    emb = emb.to(torch.bfloat16)
    acts = torch.stack(_trunk_fwd_plain(emb, wpack, bias)).to(torch.bfloat16)
    acts[-1] = _dead_rows_zero(acts[-1], live)
    return (acts[-1, :n], (emb, acts)) if save else (acts[-1, :n].clone(), None)


def trunk_bwd(
    dh: torch.Tensor,  # (N, 256) f32
    wpack: torch.Tensor,
    emb: torch.Tensor,  # (N_pad, 128) bf16, from the forward
    acts: torch.Tensor,  # (8, N_pad, 256) bf16, from the forward
    live: Optional[torch.Tensor] = None,  # the forward's
    blocks: Optional[torch.Tensor] = None,  # the forward's live_blocks(live), or None: made here
):
    """Returns (d emb (N, 128) f32, the packed trunk weight gradient (f32),
    d bias (8, 256)). Lanes the weights do not read get exact zeros. With
    `live`, d emb is zero on the blocks with no live row, and the sums run
    over the others."""
    n = dh.shape[0]
    n_pad = _padded_rows(n)
    dev = dh.device
    for name, t, dt, shape in (
        ("dh", dh, torch.float32, (n, H)),
        ("wpack", wpack, torch.bfloat16, (OFFSETS[-1],)),
        ("emb", emb, torch.bfloat16, (n_pad, EMB)),
        ("acts", acts, torch.bfloat16, (DEPTH, n_pad, H)),
    ):
        _check(name, t, dt, dev, shape)
    blocks = _blocks_for(live, blocks, n, dev)
    if _device_kind(dev) == "cpu":
        return trunk_bwd_plain(dh, wpack, emb, acts, live)
    d_emb, _, dpack, dbias, _, _ = _launch_bwd(False, None, dh, wpack, None, emb, acts, 0, 0, blocks)
    LAUNCHES["trunk_bwd"] += 1
    return d_emb, dpack, dbias


def trunk_bwd_plain(dh, wpack, emb, acts, live=None):
    """Plain PyTorch version of `trunk_bwd` (same inputs, same outputs)."""
    dh, a, e = _bwd_rows_plain(dh, acts, emb, live)
    g = dh * (a[DEPTH - 1] > 0)
    d_emb, dpack, dbias = _trunk_bwd_plain(g, wpack, a, e)
    return _dead_rows_zero(d_emb, live), dpack, dbias


class _TrunkFn(torch.autograd.Function):
    """Forward `trunk_fwd`, backward `trunk_bwd`. The output is the bf16
    activation, so autograd hands the backward a bf16 cotangent, as the JAX
    package's cast of the trunk output to f32 does."""

    @staticmethod
    def forward(ctx, save, live, inp, *trunk):
        ws, bs = trunk[:DEPTH], trunk[DEPTH:]
        in_ch = ws[0].shape[1]
        wpack = pack_trunk(ws, in_ch)
        bias = torch.stack([b.float() for b in bs]).contiguous()
        blocks = _blocks_for(live, None, inp.shape[0], inp.device)
        h, saved = trunk_fwd(inp, wpack, bias, save, live, blocks)
        if save:
            ctx.save_for_backward(wpack, *saved, live, blocks)
            ctx.in_ch = in_ch
        return h

    @staticmethod
    def backward(ctx, dh):
        wpack, emb, acts, live, blocks = ctx.saved_tensors
        d_emb, dpack, dbias = trunk_bwd(dh.float().contiguous(), wpack, emb, acts, live, blocks)
        return None, None, d_emb, *unpack_trunk(dpack, ctx.in_ch), *dbias.unbind(0)


def fused_trunk(x_emb: torch.Tensor, t_emb: torch.Tensor, ws, bs, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 8x256 trunk on (x_emb (N, E1), t_emb (N, E2) or (1, E2),
    broadcast), the port of `mlp_pallas.py:fused_trunk`: ws / bs the eight
    trunk layers (torch layout (256, fan_in): layer 0's fan_in E1 + E2, layer
    5's E1 + E2 + 256), E1 + E2 <= 128; `live` (N,) bool or None (the module
    docstring's live rows). Returns the last activation (N, 256), f32
    holding bf16 values; differentiable in x_emb, t_emb (a broadcast t_emb's
    gradient is the sum over the rows), ws and bs."""
    _check_trunk(ws, bs)
    n, e1 = x_emb.shape
    e2 = t_emb.shape[-1]
    if e1 + e2 > EMB:
        raise ValueError(f"trunk input width {e1 + e2} exceeds {EMB}")
    if ws[0].shape != (H, e1 + e2) or ws[SKIP_IN].shape != (H, e1 + e2 + H):
        raise ValueError("trunk weight shapes do not match the embeddings")
    inp = torch.cat(
        [x_emb.float(), t_emb.float().expand(n, e2), x_emb.new_zeros((n, EMB - e1 - e2), dtype=torch.float32)],
        dim=1,
    ).contiguous()
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (x_emb, t_emb, *ws, *bs))
    return _TrunkFn.apply(save, live, inp, *ws, *bs).float()
