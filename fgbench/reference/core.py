"""Plain PyTorch reference of FreeGaussian's render and stage-1 losses.

Independent of the program under test: it imports nothing of it. The
formulas are frozen copies of the port's plain versions (the files named at
each function), rewritten without the CUDA dispatch:

  - the fields (`models/fields.py`, `ops/mlp_cuda.py`'s plain versions):
    the NeRF embeddings, the blender timenet, an 8x256 ReLU trunk with the
    skip after layer 4 in bf16 operands with f32 accumulation and bf16
    activations, the heads as one f32 product, the screw axis normalised
    with the 1e-5 quirk;
  - the SE(3) screw warp (`models/fields.py:SE3Screw.apply`);
  - the EWA projection (`ops/projection.py:project_gaussians`);
  - SH colours (`ops/sh.py`), the opacity-aware radius
    (`ops/rasterize.py:tighten_radii`), the tile ranges
    (`ops/rasterize_ref.py:tile_bounds`);
  - the compositor contract (`ops/rasterize_ref.py`): front-to-back alpha
    compositing in depth order, alpha = min(0.999, o exp(-sigma)), skip
    alpha < 1/255, stop before the transmittance falls to 1e-4. Here it is
    tiled (each pixel walks the depth-sorted Gaussians of its tile) and each
    chunk of tiles is recomputed in the backward, so it runs at full frame
    size with autograd;
  - SSIM (`models/ssim.py`), the flow losses (`ops/flow.py`) and the
    learning-rate schedule (`ops/math.py:exponential_decay_schedule`).

`quant` arguments take a function applied to every product operand of the
field: the benchmark's lower-precision control passes a float8 rounding.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999
SH_C0 = 0.28209479177387814
DEFORM_HEADS = ("branch_w", "branch_v", "gaussian_rotation", "gaussian_scaling")
CONTROL_HEADS = ("d_xyz", "d_rot", "d_scale")


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + 1e-24)


def positional_embed(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]."""
    freqs = torch.tensor([2.0**i for i in range(num_freqs)], dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]
    sc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2).reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    return torch.cat([x, sc], dim=-1)


def split_linear(inputs, weight, bias, dtype, quant: Optional[Callable] = None):
    """cat(inputs) @ weight^T + bias, one product per input against its
    column slice, each in `dtype`, summed, plus the bias."""
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    q = quant or (lambda t: t)
    out, offset = None, 0
    for x in inputs:
        d = x.shape[-1]
        part = F.linear(q(x.to(dtype)), q(weight[:, offset : offset + d].to(dtype)))
        out = part if out is None else out + part
        offset += d
    return out + bias.to(dtype)


def bf16_values(t: torch.Tensor, straight: bool = False) -> torch.Tensor:
    """`t` rounded to bf16, held in f32; `straight` passes the gradient
    through unrounded (else the cast's backward rounds it to bf16)."""
    if straight:
        return t + (t.detach().to(torch.bfloat16).float() - t.detach())
    return t.to(torch.bfloat16).float()


def trunk(emb: torch.Tensor, weights: Dict[str, torch.Tensor], quant=None, skip_in: int = 5) -> torch.Tensor:
    """The 8x256 ReLU trunk with the numerics the configuration states for
    the field (`ops/mlp_cuda.py`'s plain version, `mlp_pallas.py`'s): bf16
    product operands, f32 accumulation with the f32 bias, each activation
    stored as bf16; layer `skip_in` takes [emb, h]. `emb` holds bf16
    values in f32."""
    q = quant or (lambda t: t)
    h = None
    for i in range(8):
        inp = emb if i == 0 else (torch.cat([emb, h], dim=-1) if i == skip_in else h)
        w = weights[f"linear.{i}.weight"].to(torch.bfloat16).float()
        h = bf16_values(F.relu(q(inp) @ q(w).T + weights[f"linear.{i}.bias"].float()))
    return h


def heads(h: torch.Tensor, weights: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """The heads as one f32 product of the last activation."""
    w_all = torch.cat([weights[f"{n}.weight"] for n in names])
    b_all = torch.cat([weights[f"{n}.bias"] for n in names])
    return h @ w_all.T + b_all


def deform_field(weights: Dict[str, torch.Tensor], x: torch.Tensor, t: float, *, quant=None):
    """The 8x256 blender deform field at one frame time: (w, v, theta) of
    the screw and the rotation and scaling deltas. The timenet runs as the
    port runs it, split linears in bf16 (`models/fields.py:_linear`)."""
    tt = torch.full((1, 1), float(t), dtype=torch.float32, device=x.device)
    t_emb = positional_embed(tt, 6)
    t_emb = F.relu(split_linear(t_emb, weights["timenet.0.weight"], weights["timenet.0.bias"], torch.bfloat16, quant))
    t_emb = split_linear(t_emb, weights["timenet.2.weight"], weights["timenet.2.bias"], torch.bfloat16, quant)
    x_emb = bf16_values(positional_embed(x, 10), straight=True)
    emb = torch.cat([x_emb, t_emb.float().expand(x.shape[0], t_emb.shape[-1])], dim=-1)
    y = heads(trunk(emb, weights, quant), weights, DEFORM_HEADS)
    w, v, rot, scl = y[:, 0:3], y[:, 3:6], y[:, 6:10], y[:, 10:13]
    theta = safe_norm(w, keepdim=True)
    return (w / theta + 1e-5, v / theta + 1e-5, theta), rot, scl


def control_field(weights: Dict[str, torch.Tensor], x: torch.Tensor, value: torch.Tensor, *, quant=None):
    """The 8x256 control field: (d_xyz, d_rot, d_scale) from the embedded
    position and per-point control value."""
    value = value.expand(x.shape[0], value.shape[-1])
    emb = torch.cat([bf16_values(positional_embed(x.float(), 10), straight=True),
                     bf16_values(positional_embed(value.float(), 10), straight=True)], dim=-1)
    y = heads(trunk(emb, weights, quant), weights, CONTROL_HEADS)
    return y[:, 0:3], y[:, 3:7], y[:, 7:10]


def se3_apply(screw, m: torch.Tensor) -> torch.Tensor:
    w, v, theta = screw
    th = theta[:, 0:1]
    s, c1 = torch.sin(th), 1.0 - torch.cos(th)
    c1m = torch.cross(w, m, dim=-1)
    c2m = torch.cross(w, c1m, dim=-1)
    d1 = torch.cross(w, v, dim=-1)
    d2 = torch.cross(w, d1, dim=-1)
    return (m + s * c1m + c1 * c2m) + (th * v + c1 * d1 + (th - s) * d2)


# ----------------------------------------------------------------------------
# cameras


def viewmat(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL (3, 4) camera-to-world -> OpenCV (4, 4) world-to-camera."""
    R = c2w[:3, :3] * torch.tensor([1.0, -1.0, -1.0], device=c2w.device)[None, :]
    Rinv = R.T
    out = torch.eye(4, device=c2w.device)
    out[:3, :3] = Rinv
    out[:3, 3] = -(Rinv @ c2w[:3, 3])
    return out


def intrinsics(fx, fy, cx, cy, device) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def c2w_opencv(c2w: torch.Tensor) -> torch.Tensor:
    return c2w[:3, :4] * torch.tensor([1.0, -1.0, -1.0, 1.0], device=c2w.device)[None, :]


# ----------------------------------------------------------------------------
# projection, SH, compositing


def project(means, quats, scales, vm, K, width: int, height: int, alive=None, near=0.01, far=1e10, eps2d=0.3):
    """(means2d, depths, conics, radii int32)."""
    R, t = vm[:3, :3], vm[:3, 3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    p = means @ R.T + t
    x, y, z = p.unbind(-1)
    valid = (z > near) & (z < far)
    if alive is not None:
        valid = valid & alive
    z_safe = torch.where(valid, z, torch.ones_like(z))
    x = torch.where(valid, x, torch.zeros_like(x))
    y = torch.where(valid, y, torch.zeros_like(y))
    rz = 1.0 / z_safe
    tfx, tfy = 0.5 * width / fx, 0.5 * height / fy
    tx = z_safe * torch.clamp(x * rz, -(cx / fx + 0.3 * tfx), (width - cx) / fx + 0.3 * tfx)
    ty = z_safe * torch.clamp(y * rz, -(cy / fy + 0.3 * tfy), (height - cy) / fy + 0.3 * tfy)
    qn = quats / torch.sqrt(torch.sum(quats * quats, dim=-1) + 1e-24)[..., None]
    qw, qx, qy, qz = qn.unbind(-1)
    rq = (
        (1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)),
        (2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)),
        (2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)),
    )
    A = [[R[i, 0] * rq[0][k] + R[i, 1] * rq[1][k] + R[i, 2] * rq[2][k] for k in range(3)] for i in range(3)]
    j02, j12 = -fx * tx * rz * rz, -fy * ty * rz * rz
    b0 = [fx * rz * A[0][k] + j02 * A[2][k] for k in range(3)]
    b1 = [fy * rz * A[1][k] + j12 * A[2][k] for k in range(3)]
    ss = [s * s for s in scales.unbind(-1)]
    cxx = sum(b0[k] * b0[k] * ss[k] for k in range(3)) + eps2d
    cxy = sum(b0[k] * b1[k] * ss[k] for k in range(3))
    cyy = sum(b1[k] * b1[k] * ss[k] for k in range(3)) + eps2d
    det = cxx * cyy - cxy * cxy
    inv_det = 1.0 / torch.where(det <= 0, torch.ones_like(det), det)
    conics = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)
    means2d = torch.stack([fx * x * rz + cx, fy * y * rz + cy], dim=-1)
    b = 0.5 * (cxx + cyy)
    radius = torch.ceil(3.0 * torch.sqrt(b + torch.sqrt(torch.clamp(b * b - det, min=0.01))))
    valid = valid & (det > 0) & (radius > 0)
    valid = valid & (means2d[:, 0] + radius > 0) & (means2d[:, 0] - radius < width)
    valid = valid & (means2d[:, 1] + radius > 0) & (means2d[:, 1] - radius < height)
    radii = torch.where(valid, radius, torch.zeros_like(radius)).to(torch.int32)
    conics = torch.where(valid[:, None], conics, torch.zeros_like(conics))
    return means2d, z, conics, radii


_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154, -0.4570457994644658,
       1.445305721320277, -0.5900435899266435)


def sh_colors(sh: torch.Tensor, means: torch.Tensor, vm: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """clip(SH(mean - camera position) + 0.5, 0) for sh (N, 16, 3)."""
    campos = -vm[:3, :3].T @ vm[:3, 3]
    d = means - campos
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-24)
    x, y, z = d.unbind(-1)
    basis = [SH_C0 * torch.ones_like(x)]
    if degree >= 1:
        basis += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy), _C2[3] * xz, _C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [
            _C3[0] * y * (3.0 * xx - yy), _C3[1] * xy * z, _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy), _C3[6] * x * (xx - 3.0 * yy),
        ]
    acc = basis[0][:, None] * sh[:, 0, :]
    for j in range(1, len(basis)):
        acc = acc + basis[j][:, None] * sh[:, j, :]
    return torch.clamp(acc + 0.5, min=0.0)


def tight_radii(radii: torch.Tensor, opac: torch.Tensor) -> torch.Tensor:
    """The opacity-aware radius: beyond it every pixel's alpha is under 1/255."""
    op = opac.detach()
    s2 = 2.0 * torch.log(torch.clamp(op, min=1e-30) / ALPHA_THRESHOLD)
    factor = torch.clamp(torch.sqrt(torch.clamp(s2, min=0.0)) * (1.0 / 3.0), max=1.0)
    r = radii.float() * factor
    return torch.where(op > ALPHA_THRESHOLD, r, torch.zeros_like(r))


def tile_ranges(means2d, radii, tile: int, tiles_w: int, tiles_h: int):
    r = radii.to(means2d.dtype)
    mx, my = means2d[:, 0], means2d[:, 1]
    tx0 = torch.clamp(torch.floor((mx - r) / tile), 0, tiles_w).long()
    tx1 = torch.clamp(torch.ceil((mx + r) / tile), 0, tiles_w).long()
    ty0 = torch.clamp(torch.floor((my - r) / tile), 0, tiles_h).long()
    ty1 = torch.clamp(torch.ceil((my + r) / tile), 0, tiles_h).long()
    return tx0, tx1, ty0, ty1


def count_pairs(means2d, radii_px, width: int, height: int, tile: int) -> int:
    """(Gaussian, tile) pairs of the binning at `tile`."""
    tw, th = -(-width // tile), -(-height // tile)
    tx0, tx1, ty0, ty1 = tile_ranges(means2d.detach(), radii_px, tile, tw, th)
    n = torch.where(radii_px > 0, (tx1 - tx0) * (ty1 - ty0), torch.zeros_like(tx0))
    return int(n.sum())


def _bin(means2d, depths, radii_px, tile, tw, th):
    """Pairs sorted by (tile, depth): (gaussian ids, per-tile offsets)."""
    tx0, tx1, ty0, ty1 = tile_ranges(means2d, radii_px, tile, tw, th)
    wx = tx1 - tx0
    n = torch.where(radii_px > 0, wx * (ty1 - ty0), torch.zeros_like(wx))
    gid = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device), n)
    start = torch.cumsum(n, 0) - n
    k = torch.arange(gid.shape[0], device=n.device) - start[gid]
    wxg = torch.clamp(wx[gid], min=1)
    tid = (ty0[gid] + k // wxg) * tw + tx0[gid] + k % wxg
    order = torch.argsort(depths[gid], stable=True)
    order = order[torch.argsort(tid[order], stable=True)]
    counts = torch.bincount(tid, minlength=tw * th)
    return gid[order], counts


def _tile_block(m, con, op, col, valid, ox, oy, tile: int, count_walk: bool):
    """One chunk of tiles: every (tile pixel, Gaussian slot) pair of the
    (T, K) gathered inputs as a (T, P, K) block, composited front to back.
    (render (T, P, C), alpha (T, P)[, walked pairs])."""
    py_in, px_in = torch.meshgrid(torch.arange(tile, device=m.device), torch.arange(tile, device=m.device),
                                  indexing="ij")
    px_in, py_in = px_in.reshape(-1).float(), py_in.reshape(-1).float()
    px = ox[:, None] + px_in[None, :] + 0.5  # (T, P)
    py = oy[:, None] + py_in[None, :] + 0.5
    dx = m[:, None, :, 0] - px[:, :, None]  # (T, P, K)
    dy = m[:, None, :, 1] - py[:, :, None]
    sigma = 0.5 * (con[:, None, :, 0] * dx * dx + con[:, None, :, 2] * dy * dy) + con[:, None, :, 1] * dx * dy
    alpha = torch.clamp(op[:, None, :] * torch.exp(-sigma), max=MAX_ALPHA)
    vis = valid[:, None, :] & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD)
    a_eff = torch.where(vis, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - a_eff
    excl = torch.cumprod(torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], -1), -1)
    incl = excl * one_minus
    done = torch.cummax((incl <= TRANSMITTANCE_EPS).to(torch.int32), dim=-1).values > 0
    w = torch.where(vis & ~done, a_eff * excl, torch.zeros_like(a_eff))
    out = (torch.einsum("tpk,tkc->tpc", w, col), w.sum(-1))
    if count_walk:
        out += ((valid[:, None, :] & ~done).sum() + done[..., -1].sum(),)
    return out


class _RecomputedBlock(torch.autograd.Function):
    """`_tile_block` that keeps only its (T, K) inputs for the backward and
    recomputes the (T, P, K) block there, by the same ops, to take its
    gradients."""

    @staticmethod
    def forward(ctx, m, con, op, col, valid, ox, oy, tile: int, count_walk: bool):
        ctx.save_for_backward(m, con, op, col, valid, ox, oy)
        ctx.tile = tile
        out = _tile_block(m, con, op, col, valid, ox, oy, tile, count_walk)
        if count_walk:
            ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, g_render, g_alpha, *_):
        m, con, op, col, valid, ox, oy = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (m, con, op, col)]
            render, alpha = _tile_block(*leaves, valid, ox, oy, ctx.tile, False)
            # a scalar whose gradients by render and alpha are g_render and
            # g_alpha exactly (1 * g): `grad_outputs` would import sympy on
            # the first call, seconds of every run's set-up
            grads = torch.autograd.grad((render * g_render).sum() + (alpha * g_alpha).sum(), leaves)
        return (*grads, None, None, None, None, None)


def composite(means2d, conics, colors, opac, depths, radii_px, width: int, height: int, *, tile: int = 16,
              tiles_per_chunk: int = 32, count_walk: bool = False):
    """(render (H, W, C), alpha (H, W, 1)[, walked pairs]): every pixel
    composites the Gaussians of its tile front to back.

    The backward recomputes each chunk's (T, P, K) block from the chunk's
    gathered (T, K) inputs (`_RecomputedBlock`), so what autograd keeps
    grows with the pairs (T K), not with the pixels times the pairs
    (T P K), and one chunk's block lives at a time."""
    dev = means2d.device
    tw, th = -(-width // tile), -(-height // tile)
    with torch.no_grad():
        gids, counts = _bin(means2d.detach(), depths.detach(), radii_px, tile, tw, th)
        offsets = torch.cumsum(counts, 0) - counts
        counts_h, offsets_h = counts.tolist(), offsets.tolist()
    P = tile * tile
    C = colors.shape[-1]
    renders, alphas, walked = [], [], 0
    for c0 in range(0, tw * th, tiles_per_chunk):
        tiles = list(range(c0, min(c0 + tiles_per_chunk, tw * th)))
        K = max(counts_h[t] for t in tiles)
        T = len(tiles)
        if K == 0:
            renders.append(torch.zeros((T, P, C), device=dev, dtype=colors.dtype))
            alphas.append(torch.zeros((T, P), device=dev, dtype=colors.dtype))
            continue
        with torch.no_grad():
            kk = torch.arange(K, device=dev)
            cnt = torch.tensor([counts_h[t] for t in tiles], device=dev)
            off = torch.tensor([offsets_h[t] for t in tiles], device=dev)
            valid = kk[None, :] < cnt[:, None]
            idx = torch.where(valid, gids[torch.clamp(off[:, None] + kk[None, :], max=max(gids.shape[0] - 1, 0))], 0)
            tt = torch.tensor(tiles, device=dev)
            ox, oy = (tt % tw).float() * tile, (tt // tw).float() * tile
        out = _RecomputedBlock.apply(means2d[idx], conics[idx], opac[idx], colors[idx], valid, ox, oy, tile,
                                     count_walk)
        renders.append(out[0])
        alphas.append(out[1])
        if count_walk:
            walked += int(out[2])
    r = torch.cat(renders).reshape(th, tw, tile, tile, C).permute(0, 2, 1, 3, 4).reshape(th * tile, tw * tile, C)
    a = torch.cat(alphas).reshape(th, tw, tile, tile).permute(0, 2, 1, 3).reshape(th * tile, tw * tile)
    res = (r[:height, :width], a[:height, :width, None])
    return res + (walked,) if count_walk else res


# ----------------------------------------------------------------------------
# losses


def _gauss_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(coords**2) / (2 * sigma**2))
    return (g / g.sum()).float().to(device)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of (H, W, C) images: 11-tap Gaussian window (sigma 1.5),
    valid padding, K1 0.01, K2 0.03, data range 1."""
    a = img1.permute(2, 0, 1)[None]
    b = img2.permute(2, 0, 1)[None]
    c = a.shape[1]
    win = _gauss_window(device=a.device)
    x = torch.cat([a, b, a * a, b * b, a * b], dim=1)
    x = F.conv2d(x, win.view(1, 1, 11, 1).expand(5 * c, 1, 11, 1), groups=5 * c)
    x = F.conv2d(x, win.view(1, 1, 1, 11).expand(5 * c, 1, 1, 11), groups=5 * c)
    mu1, mu2, e11, e22, e12 = x.split(c, dim=1)
    c1, c2 = 0.01**2, 0.03**2
    s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    return torch.mean(((2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)) * cs)


def bilinear(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """image (H, W, C) sampled at (x, y) (N,), clamped: (N, C)."""
    h, w = image.shape[:2]
    x = torch.clamp(x, 0, w - 1)
    y = torch.clamp(y, 0, h - 1)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    return (((1 - fx) * (1 - fy))[:, None] * image[y0, x0] + ((1 - fx) * fy)[:, None] * image[y1, x0]
            + (fx * (1 - fy))[:, None] * image[y0, x1] + (fx * fy)[:, None] * image[y1, x1])


def lift_flow(means2d, depth0, flow, c2w0_cv, K, alive):
    """Each projected centre advected by the flow, lifted by the paired
    frame's depth through K^-1 and the paired OpenCV c2w: (targets, valid)."""
    h, w = depth0.shape[:2]
    x, y = means2d[:, 0], means2d[:, 1]
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h) & alive
    xs = torch.where(inb, x, torch.zeros_like(x))
    ys = torch.where(inb, y, torch.zeros_like(y))
    f = bilinear(flow, xs, ys)
    x2, y2 = xs + f[:, 0], ys + f[:, 1]
    Z = bilinear(depth0, x2, y2)[:, 0]
    Kinv = torch.linalg.inv(K.double()).float()
    p_cam = (torch.stack([x2, y2, torch.ones_like(x2)], -1) @ Kinv.T) * Z[:, None]
    p_world = p_cam @ c2w0_cv[:3, :3].T + c2w0_cv[:3, 3]
    return torch.where(inb[:, None], p_world, torch.zeros_like(p_world)), inb


def flow_3d_loss(means_prev, target, valid, radii, alive):
    mask = valid & (radii > 0) & alive
    per_g = torch.sum(torch.abs(means_prev - target.detach()), dim=-1)
    return torch.sum(torch.where(mask, per_g, torch.zeros_like(per_g))) / torch.clamp(mask.sum(), min=1)


def flow_2d_loss(rendered_flow, interflow, alpha):
    w = alpha.detach()
    return torch.sum(w * torch.abs(rendered_flow + interflow)) / torch.clamp(torch.sum(w) * 2.0, min=1.0)


# ----------------------------------------------------------------------------
# Adam


def exp_decay(lr_init: float, lr_final: float, max_steps: int, step: int) -> float:
    """nerfstudio's exponential decay without warm-up, in f32."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    t = torch.clamp(f32(step) / max(max_steps, 1), 0.0, 1.0)
    return float(torch.exp(torch.log(f32(lr_init)) * (1 - t) + torch.log(f32(lr_final)) * t))


def adam_step(p, g, mu, nu, lr: float, count: int, b1=0.9, b2=0.999, eps=1e-15):
    """optax adam at `count` (before the increment), in place on p, mu, nu."""
    mu.mul_(b1).add_(g * (1 - b1))
    nu.mul_(b2).add_(g * g * (1 - b2))
    bc1 = 1.0 / float(torch.tensor(1 - b1 ** (count + 1), dtype=torch.float32))
    bc2 = 1.0 / float(torch.tensor(1 - b2 ** (count + 1), dtype=torch.float32))
    p.add_((mu * bc1) / (torch.sqrt(nu * bc2) + eps) * -lr)


def lr_of(group: str, lrs: Dict[str, float], max_steps: int, count: int) -> float:
    """The port's per-group rates (`engine/optimizers.py:make_optimizers`)
    with spatial_lr_scale folded into `lrs`."""
    sched = lrs.get(group)
    if isinstance(sched, tuple):
        return exp_decay(sched[0], sched[1], max_steps if len(sched) == 2 else sched[2], count)
    return float(sched)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """The control's rounding: a product operand through float8 e4m3, with
    the gradient passed straight through."""
    return t + (t.detach().to(torch.float8_e4m3fn).to(t.dtype) - t.detach())


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def norm_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return abs(float(prog.double().norm()) - float(ref.double().norm()))

