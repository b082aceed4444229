"""The fused deform field: CUDA kernel wrappers and their plain PyTorch versions.

`deform_field(x, t_row, ws, bs, head_w, head_b)` runs the whole deform field
(the NeRF embedding of x, the 8x256 bf16 ReLU trunk with its skip, the 13
packed f32 head lanes) for one shared time row, differentiably in x, t_row
and every weight. Its forward is `deform_field_fwd`, its backward
`deform_field_bwd`. On a CUDA tensor each launches its kernel of
`csrc/deform_field.cu` (the ports of the TPU kernels
`freegaussian_tpu/ops/mlp_pallas.py:_fused_field_heads_fwd` and
`_fused_field_heads_bwd`) or raises; on a CPU tensor each runs its plain
version, which computes the same function with the same rounding points:
bf16 product operands with f32 accumulation, f32 bias and ReLU, bf16-stored
activations, f32 heads; the backward's products take bf16(g).

The trunk weights travel packed (`pack_trunk`): layer i as a (256, K_i)
bf16 row-major block, K_0 = 96 (the embedding lanes, zero padded), K_5 =
96 + 256 (the skip), 256 otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from .math import positional_embed

H = 256  # trunk width
DEPTH = 8
SKIP_IN = 5  # the layer that takes [emb | h_4]
EMB = 96  # embedding lanes: the x lanes, the time lanes, zero padding
NOUT = 13  # packed head lanes: w (3) | v (3) | rotation (4) | scaling (3)
ROWS = 64  # rows of one kernel block; row counts are padded to a multiple
# Shares of the rows over which the weight-gradient kernel splits its sums
# (the wrapper adds the shares in order); enough blocks for 132 SMs.
WGRAD_SPLITS = 8

# Kernel launches by kernel name. Each wrapper adds one where it launches its
# kernel and nowhere else; `chip_smoke.py` zeroes and reads it.
LAUNCHES = {"deform_fwd": 0, "deform_bwd": 0}
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
        if name == "deform_fwd":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [
                ctypes.c_void_p
            ] * 7 + [ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_int,
            ] + [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        size = lib.deform_packed_size
        size.restype = ctypes.c_long
        if size() != OFFSETS[-1]:
            raise RuntimeError(f"deform_field.cu packs {size()} weights, this module {OFFSETS[-1]}")
        err = lib.deform_field_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[name] = (fn, err)
    return _fns[name]


def _padded_rows(n: int) -> int:
    return max(-(-n // ROWS), 1) * ROWS


def _check(name, t, dtype, device, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_lanes(x_lanes: int, t_lanes: int):
    if x_lanes < 3 or x_lanes % 3 or (x_lanes // 3) % 2 != 1 or x_lanes + t_lanes > EMB:
        raise ValueError(f"the fused field takes 3 (1 + 2 L) x lanes and at most {EMB} lanes, got {x_lanes} + {t_lanes}")


def pack_trunk(ws, in_ch: int) -> torch.Tensor:
    """The eight trunk weights (torch layout (256, fan_in)) as one bf16 vector:
    layer 0's input columns and layer 5's embedding columns padded to 96."""
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


# ---------------------------------------------------------------------------
# forward
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
):
    """Returns y (N, 13) f32 and, with `save`, the backward's inputs: the
    bf16 embedding (N_pad, 96) and activations (8, N_pad, 256), rows padded
    to a multiple of 64 (the padded rows hold x = 0)."""
    n = x.shape[0]
    dev = x.device
    _check_lanes(x_lanes, t_row.shape[0])
    for name, t, dt, shape in (
        ("x", x, torch.float32, (n, 3)),
        ("t_row", t_row, torch.float32, (t_row.shape[0],)),
        ("wpack", wpack, torch.bfloat16, (OFFSETS[-1],)),
        ("bias", bias, torch.float32, (DEPTH, H)),
        ("head_w", head_w, torch.float32, (NOUT, H)),
        ("head_b", head_b, torch.float32, (NOUT,)),
    ):
        _check(name, t, dt, dev, shape)
    if dev.type == "cpu":
        return deform_field_fwd_plain(x, t_row, wpack, bias, head_w, head_b, x_lanes, save)
    if dev.type != "cuda":
        raise ValueError(f"the deform field runs on cuda or cpu tensors, got {dev}")

    fn, err = _kernel("deform_fwd")
    n_pad = _padded_rows(n)
    y = torch.empty((n, NOUT), dtype=torch.float32, device=dev)
    emb = acts = None
    if save:
        emb = torch.empty((n_pad, EMB), dtype=torch.bfloat16, device=dev)
        acts = torch.empty((DEPTH, n_pad, H), dtype=torch.bfloat16, device=dev)
    rc = fn(
        x.data_ptr(), n, t_row.data_ptr(), x_lanes, t_row.shape[0], wpack.data_ptr(), bias.data_ptr(),
        head_w.data_ptr(), head_b.data_ptr(), y.data_ptr(),
        emb.data_ptr() if save else None, acts.data_ptr() if save else None, n_pad,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"deform_fwd launch failed: {err(rc).decode()} (cudaError {rc})")
    LAUNCHES["deform_fwd"] += 1
    return y, ((emb, acts) if save else None)


def _embed_plain(x: torch.Tensor, t_row: torch.Tensor, x_lanes: int, n_pad: int) -> torch.Tensor:
    """The (N_pad, 96) bf16 embedding rows, x = 0 on the padded rows."""
    xp = torch.zeros((n_pad, 3), dtype=torch.float32, device=x.device)
    xp[: x.shape[0]] = x
    emb = torch.zeros((n_pad, EMB), dtype=torch.float32, device=x.device)
    emb[:, :x_lanes] = positional_embed(xp, (x_lanes // 3 - 1) // 2)
    emb[:, x_lanes : x_lanes + t_row.shape[0]] = t_row
    return emb.to(torch.bfloat16)


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def deform_field_fwd_plain(x, t_row, wpack, bias, head_w, head_b, x_lanes: int, save: bool):
    """Plain PyTorch version of `deform_field_fwd` (same inputs, same outputs)."""
    n = x.shape[0]
    n_pad = _padded_rows(n)
    emb = _embed_plain(x, t_row, x_lanes, n_pad)
    e = emb.float()
    h = None
    acts = []
    for i in range(DEPTH):
        inp = e if i == 0 else (torch.cat([e, h], dim=1) if i == SKIP_IN else h)
        z = inp @ _layer(wpack, i).float().t() + bias[i]
        h = _bf16_values(torch.relu(z))
        acts.append(h.to(torch.bfloat16))
    y = (h[:n] @ head_w.t() + head_b).contiguous()
    return y, ((emb, torch.stack(acts)) if save else None)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def deform_field_bwd(
    x: torch.Tensor,  # (N, 3) f32
    dy: torch.Tensor,  # (N, 13) f32
    wpack: torch.Tensor,
    head_w: torch.Tensor,
    emb: torch.Tensor,  # (N_pad, 96) bf16, from the forward
    acts: torch.Tensor,  # (8, N_pad, 256) bf16, from the forward
    x_lanes: int,
):
    """Returns (dx (N, 3), the row sum of d emb (96,), the packed trunk
    weight gradient (f32), d bias (8, 256), d head_w (13, 256), d head_b (13,))."""
    n = x.shape[0]
    n_pad = _padded_rows(n)
    dev = x.device
    _check_lanes(x_lanes, 0)
    for name, t, dt, shape in (
        ("x", x, torch.float32, (n, 3)),
        ("dy", dy, torch.float32, (n, NOUT)),
        ("wpack", wpack, torch.bfloat16, (OFFSETS[-1],)),
        ("head_w", head_w, torch.float32, (NOUT, H)),
        ("emb", emb, torch.bfloat16, (n_pad, EMB)),
        ("acts", acts, torch.bfloat16, (DEPTH, n_pad, H)),
    ):
        _check(name, t, dt, dev, shape)
    if dev.type == "cpu":
        return deform_field_bwd_plain(x, dy, wpack, head_w, emb, acts, x_lanes)
    if dev.type != "cuda":
        raise ValueError(f"the deform field runs on cuda or cpu tensors, got {dev}")

    fn, err = _kernel("deform_bwd")
    f32 = dict(dtype=torch.float32, device=dev)
    G = torch.empty((DEPTH, n_pad, H), dtype=torch.bfloat16, device=dev)
    dbias = torch.zeros((DEPTH, H), **f32)
    dhw = torch.zeros((NOUT, H), **f32)
    dhb = torch.zeros((NOUT,), **f32)
    demb = torch.zeros((EMB,), **f32)
    dx = torch.empty((n, 3), **f32)
    splits = max(1, min(WGRAD_SPLITS, n_pad // ROWS))
    partial = torch.empty((splits, OFFSETS[-1]), **f32)
    rc = fn(
        x.data_ptr(), n, x_lanes, dy.data_ptr(), wpack.data_ptr(), head_w.data_ptr(), emb.data_ptr(),
        acts.data_ptr(), n_pad, splits, G.data_ptr(), dbias.data_ptr(), dhw.data_ptr(), dhb.data_ptr(),
        demb.data_ptr(), dx.data_ptr(), partial.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"deform_bwd launch failed: {err(rc).decode()} (cudaError {rc})")
    LAUNCHES["deform_bwd"] += 1
    return dx, demb, partial.sum(0), dbias, dhw, dhb


def deform_field_bwd_plain(x, dy, wpack, head_w, emb, acts, x_lanes: int):
    """Plain PyTorch version of `deform_field_bwd` (same inputs, same outputs)."""
    n = x.shape[0]
    a = [acts[i, :n].float() for i in range(DEPTH)]
    e = emb[:n].float()
    dhb = dy.sum(0)
    dhw = dy.t() @ a[DEPTH - 1]
    g = (dy @ head_w) * (a[DEPTH - 1] > 0)
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
    # dx through the embedding: lane (b, c) is x_c, sin(f x_c) or cos(f x_c)
    dx = d_emb[:, 0:3].clone()
    for b in range(1, x_lanes // 3):
        f = float(2 ** ((b - 1) // 2))
        sc = x * f
        deriv = torch.cos(sc) if b % 2 else -torch.sin(sc)
        dx = dx + d_emb[:, 3 * b : 3 * b + 3] * deriv * f
    return dx, d_emb.sum(0), torch.cat([w.reshape(-1) for w in dws]), torch.stack(dbias), dhw, dhb


# ---------------------------------------------------------------------------
# the differentiable field
# ---------------------------------------------------------------------------


class _DeformFieldFn(torch.autograd.Function):
    """Forward `deform_field_fwd`, backward `deform_field_bwd`; gradients in
    f32 for x, the time row and every master weight."""

    @staticmethod
    def forward(ctx, save, x, t_row, head_w, head_b, *trunk):
        ws, bs = trunk[:DEPTH], trunk[DEPTH:]
        in_ch = ws[0].shape[1]
        x_lanes = in_ch - t_row.shape[0]
        wpack = pack_trunk(ws, in_ch)
        bias = torch.stack([b.float() for b in bs]).contiguous()
        y, saved = deform_field_fwd(x, t_row, wpack, bias, head_w, head_b, x_lanes, save)
        if save:
            ctx.save_for_backward(x, wpack, head_w, *saved)
            ctx.dims = (in_ch, x_lanes, t_row.shape[0])
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wpack, head_w, emb, acts = ctx.saved_tensors
        in_ch, x_lanes, t_lanes = ctx.dims
        dx, demb, dpack, dbias, dhw, dhb = deform_field_bwd(
            x, dy.float().contiguous(), wpack, head_w, emb, acts, x_lanes
        )
        return (
            None, dx, demb[x_lanes : x_lanes + t_lanes], dhw, dhb, *unpack_trunk(dpack, in_ch), *dbias.unbind(0)
        )


def deform_field(x, t_row, ws, bs, head_w, head_b) -> torch.Tensor:
    """The fused deform field: x (N, 3), t_row (t_lanes,) the shared time
    embedding, ws / bs the eight trunk layers (torch layout: (256, fan_in),
    fan_in = x lanes + t lanes for layers 0 and 5's leading columns),
    head_w (13, 256) and head_b (13,) the packed heads. Returns (N, 13) f32."""
    if len(ws) != DEPTH or len(bs) != DEPTH or ws[1].shape != (H, H):
        raise ValueError(f"the fused field is {DEPTH} layers of {H}")
    inputs = (x, t_row, head_w, head_b, *ws, *bs)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    return _DeformFieldFn.apply(
        save, x.float().contiguous(), t_row.float().contiguous(), head_w.float().contiguous(),
        head_b.float().contiguous(), *ws, *bs,
    )
