"""Deformation and control fields (twin of `freegaussian_tpu/models/fields.py`).

`DeformField` is the reference's time-conditioned SE(3) field and
`ControlField` its stage-2 control field, as nn.Modules whose submodule
names are the reference checkpoint's keys (deform: `timenet.0`, `timenet.2`,
`linear.0-7`, `branch_w`, `branch_v`, `gaussian_rotation`,
`gaussian_scaling`; control: `linear.0-7`, `d_xyz`, `d_rot`, `d_scale`), so a
reference state_dict loads directly. Their split-linear forwards follow
`deform_apply_headsfused` / `control_apply_headsfused`: the timenet runs
once for a shared frame time and is broadcast, the trunk has its skip after
layer 4, and the heads compute in f32 from the trunk's output as one packed
product.

Every layer whose input is a list (the skip layer takes [x_emb, t_emb, h])
is a split linear as in the JAX package: one product per input against its
slice of the weight, each rounded to the compute dtype, summed, plus the
bias. With compute_dtype=bfloat16 the rounding points are then the JAX
package's; what remains is the f32 accumulation order inside each product.
Every f32 product (the heads, and the trunk in f32 mode) is held to full
f32 on the GPU (no TF32).

`impl` picks the trunk's implementation for an 8x256 field (`ops/mlp_cuda.py`,
bf16 product operands with f32 accumulation and bf16-stored activations, the
numerics of `mlp_pallas.py`):
  "split"   the split-linear chain above;
  "fused"   (deform, bf16) the embedding, the trunk and the four heads as one
            kernel pair, the port of `deform_apply_fused(impl="fused")`;
  "pallas"  the embedding and the trunk as one kernel pair, the heads in f32
            outside, the port of `deform_apply_fused(impl="pallas")` (deform,
            bf16, with the timenet output as the shared time row) and of
            `control_apply_fused(impl="pallas")` (control: the embeddings of
            the position and of the per-point control value).
With per-point times (t of shape (N, 1)) both deform modes build the
embeddings here and run the trunk alone on them (`fused_trunk`), the heads
in f32 outside, as `deform_apply_fused` does under either impl.
The timenet and the screw-axis normalization stay here in every mode.

Both forwards take `live`, the Gaussians' (N,) bool `alive` or None: the
kernel modes pass it to `ops/mlp_cuda.py`, whose kernels then work only on
the 128-row blocks that hold a live row (the others' outputs are zeros:
the screw axis there is the 1e-5 offset, finite); the split-linear chains
compute every row. Either way the rows that a caller reads are the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.math import positional_embed, safe_norm
from ..ops.mlp_cuda import deform_field, field_trunk, fused_trunk

HEAD_NAMES = ("branch_w", "branch_v", "gaussian_rotation", "gaussian_scaling")
CONTROL_HEAD_NAMES = ("d_xyz", "d_rot", "d_scale")
IMPLS = ("split", "fused", "pallas")


def _new_linear(fan_in: int, fan_out: int) -> nn.Linear:
    # uninitialized: the weights come from a checkpoint or the weight bridge
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out)


def _linear(inputs, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`cat(inputs) @ weight^T + bias` as the JAX package's split linear
    computes it (fields.py:_split_linear_fwd_math): one product per input
    against its column slice of `weight`, summed in `dtype`, then the bias."""
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    out = None
    offset = 0
    for x in inputs:
        d = x.shape[-1]
        part = F.linear(x.to(dtype), weight[:, offset : offset + d].to(dtype))
        out = part if out is None else out + part
        offset += d
    return out + bias.to(dtype)


class SE3Screw(NamedTuple):
    """Screw-axis SE(3) transform, channelized: w, v (N, 3) and theta (N, 1).

      R m = m + sin(th) (w x m) + (1 - cos(th)) (w x (w x m))
      p   = th v + (1 - cos(th)) (w x v) + (th - sin(th)) (w x (w x v))
    """

    w: torch.Tensor
    v: torch.Tensor
    theta: torch.Tensor

    def apply(self, means: torch.Tensor) -> torch.Tensor:
        wx, wy, wz = self.w.unbind(-1)
        vx, vy, vz = self.v.unbind(-1)
        mx, my, mz = means.unbind(-1)
        th = self.theta[:, 0]
        s = torch.sin(th)
        c1 = 1.0 - torch.cos(th)
        ts = th - s

        def cross(ax, ay, az, bx, by, bz):
            return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)

        c1x, c1y, c1z = cross(wx, wy, wz, mx, my, mz)
        c2x, c2y, c2z = cross(wx, wy, wz, c1x, c1y, c1z)
        rx = mx + s * c1x + c1 * c2x
        ry = my + s * c1y + c1 * c2y
        rz = mz + s * c1z + c1 * c2z
        d1x, d1y, d1z = cross(wx, wy, wz, vx, vy, vz)
        d2x, d2y, d2z = cross(wx, wy, wz, d1x, d1y, d1z)
        px = th * vx + c1 * d1x + ts * d2x
        py = th * vy + c1 * d1y + ts * d2y
        pz = th * vz + c1 * d1z + ts * d2z
        return torch.stack([rx + px, ry + py, rz + pz], dim=-1)


def apply_se3_deform(means: torch.Tensor, d_xyz: SE3Screw) -> torch.Tensor:
    """means' = d_xyz applied to means."""
    return d_xyz.apply(means)


class DeformField(nn.Module):
    """SE(3) deformation field (reference freegaussian_model.py:1054-1114)."""

    def __init__(
        self,
        depth: int = 8,
        width: int = 256,
        multires: int = 10,
        is_blender: bool = True,
        compute_dtype: torch.dtype = torch.float32,
        impl: str = "split",
    ):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if impl != "split" and (depth, width, compute_dtype) != (8, 256, torch.bfloat16):
            raise ValueError(f"the fused deform field is 8x256 bf16, got {depth}x{width} {compute_dtype}")
        self.impl = impl
        self.depth = depth
        self.multires = multires
        self.is_blender = is_blender
        self.compute_dtype = compute_dtype
        self.t_multires = 6 if is_blender else 10
        self.skip_at = depth // 2
        x_ch = 3 * (1 + 2 * multires)
        t_ch = 1 + 2 * self.t_multires
        if is_blender:
            self.timenet = nn.Sequential(_new_linear(t_ch, 256), nn.ReLU(), _new_linear(256, 30))
            t_ch = 30
        in_ch = x_ch + t_ch
        self.linear = nn.ModuleList(
            [_new_linear(in_ch, width)]
            + [_new_linear(width + in_ch if i == self.skip_at else width, width) for i in range(depth - 1)]
        )
        # the skip follows layer depth // 2: for depth <= 2 that is the last
        # layer, and the heads see [x_emb, t_emb, h]
        head_in = width + in_ch if self.skip_at == depth - 1 else width
        self.branch_w = _new_linear(head_in, 3)
        self.branch_v = _new_linear(head_in, 3)
        self.gaussian_rotation = _new_linear(head_in, 4)
        self.gaussian_scaling = _new_linear(head_in, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, head_init_scale: float = 1.0) -> "DeformField":
        """torch nn.Linear's default init, U(+-1/sqrt(fan_in)) for weights and
        biases, drawn from `generator` (on the CPU) in state_dict order; the
        four heads' weights and biases times `head_init_scale`, as the JAX
        package's `DeformField.head_init_scale` initializes them."""
        heads = {getattr(self, n) for n in HEAD_NAMES}
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                _torch_default_init(layer, generator, head_init_scale if layer in heads else 1.0)
        return self

    def forward(self, x: torch.Tensor, t: torch.Tensor, live: Optional[torch.Tensor] = None):
        """x: (N, 3) canonical means; t: (1, 1) shared frame time or (N, 1);
        live: (N,) bool or None (the module docstring).

        Returns (d_xyz SE3Screw, d_rotation (N, 4), d_scaling (N, 3))."""
        ct = self.compute_dtype
        _no_tf32(x)  # the heads always, the trunk in f32 mode
        t_emb = positional_embed(t, self.t_multires)
        if self.is_blender:
            t0, t2 = self.timenet[0], self.timenet[2]
            t_emb = F.relu(_linear(t_emb, t0.weight, t0.bias, ct))
            t_emb = _linear(t_emb, t2.weight, t2.bias, ct)
        heads = [getattr(self, n) for n in HEAD_NAMES]
        w_all = torch.cat([hd.weight for hd in heads], dim=0)
        b_all = torch.cat([hd.bias for hd in heads], dim=0)
        ws, bs = [l.weight for l in self.linear], [l.bias for l in self.linear]
        if self.impl != "split" and t_emb.shape[0] != 1:
            h = fused_trunk(positional_embed(x.float(), self.multires), t_emb, ws, bs, live=live)
            y = _linear(h, w_all, b_all, torch.float32)
        elif self.impl == "fused":
            y = deform_field(x, t_emb[0], ws, bs, w_all, b_all, live=live)
        elif self.impl == "pallas":
            y = _linear(field_trunk(x, None, t_emb[0], ws, bs, live=live), w_all, b_all, torch.float32)
        else:
            y = self._split_forward(x, t_emb, w_all, b_all)
        w, v, rotation, scaling = y[:, 0:3], y[:, 3:6], y[:, 6:10], y[:, 10:13]
        theta = safe_norm(w, dim=-1, keepdim=True)
        # Reference quirk kept verbatim: the 1e-5 is added after the division.
        w = w / theta + 1e-5
        v = v / theta + 1e-5
        return SE3Screw(w=w, v=v, theta=theta), rotation, scaling

    def _split_forward(self, x, t_emb, w_all, b_all):
        """The trunk as split linears in the compute dtype, then the four
        heads as one (13, fan_in) f32 product. Returns (N, 13) f32."""
        ct = self.compute_dtype
        t_emb = t_emb.expand(x.shape[0], t_emb.shape[-1])
        x_emb = positional_embed(x, self.multires)
        x_emb = x_emb.to(ct)
        t_emb = t_emb.to(ct)

        h = [x_emb, t_emb]
        for i, layer in enumerate(self.linear):
            h = F.relu(_linear(h, layer.weight, layer.bias, ct))
            if i == self.skip_at:
                h = [x_emb, t_emb, h]
        if isinstance(h, torch.Tensor):
            h = [h]
        h = [a.float() for a in h]
        return _linear(h, w_all, b_all, torch.float32)


def _torch_default_init(layer: nn.Linear, generator: torch.Generator, scale: float = 1.0):
    bound = 1.0 / math.sqrt(layer.weight.shape[1])
    for p in (layer.weight, layer.bias):
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound * scale)


def _no_tf32(x: torch.Tensor):
    if x.is_cuda:
        # f32 products stay full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class ControlField(nn.Module):
    """Control field: (position, blended control value) -> per-Gaussian
    (d_xyz (N, 3), d_rot (N, 4), d_scale (N, 3)) (reference
    freegaussian_model.py:1117-1145). An f32 field, as in the JAX package;
    with impl="pallas" (8x256 only) its trunk runs the bf16 kernel pair."""

    def __init__(self, depth: int = 8, width: int = 256, multires: int = 10, impl: str = "split"):
        super().__init__()
        if impl not in ("split", "pallas"):
            raise ValueError(f"the control field's impl is 'split' or 'pallas', got {impl!r}")
        if impl == "pallas" and (depth, width) != (8, 256):
            raise ValueError(f"the fused control trunk is 8x256, got {depth}x{width}")
        self.impl = impl
        self.depth = depth
        self.multires = multires
        self.skip_at = depth // 2
        in_ch = 2 * 3 * (1 + 2 * multires)
        self.linear = nn.ModuleList(
            [_new_linear(in_ch, width)]
            + [_new_linear(width + in_ch if i == self.skip_at else width, width) for i in range(depth - 1)]
        )
        head_in = width + in_ch if self.skip_at == depth - 1 else width
        self.d_xyz = _new_linear(head_in, 3)
        self.d_rot = _new_linear(head_in, 4)
        self.d_scale = _new_linear(head_in, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "ControlField":
        """torch nn.Linear's default init, U(+-1/sqrt(fan_in)) for weights and
        biases, drawn from `generator` (on the CPU) in state_dict order."""
        for layer in [*self.linear, *(getattr(self, n) for n in CONTROL_HEAD_NAMES)]:
            _torch_default_init(layer, generator)
        return self

    def forward(self, x: torch.Tensor, value: torch.Tensor, live: Optional[torch.Tensor] = None):
        """x: (N, 3) positions; value: (N, 3) or (1, 3) blended control state;
        live: (N,) bool or None (the module docstring). Returns (d_xyz,
        d_rot, d_scale), f32."""
        _no_tf32(x)
        value = value.expand(x.shape[0], value.shape[-1])
        heads = [getattr(self, n) for n in CONTROL_HEAD_NAMES]
        w_all = torch.cat([hd.weight for hd in heads], dim=0)
        b_all = torch.cat([hd.bias for hd in heads], dim=0)
        if self.impl == "pallas":
            h = field_trunk(x, value, None, [l.weight for l in self.linear], [l.bias for l in self.linear], live=live)
        else:
            x_emb = positional_embed(x.float(), self.multires)
            v_emb = positional_embed(value.float(), self.multires)
            h = [x_emb, v_emb]
            for i, layer in enumerate(self.linear):
                h = F.relu(_linear(h, layer.weight, layer.bias, torch.float32))
                if i == self.skip_at:
                    h = [x_emb, v_emb, h]
        y = _linear(h, w_all, b_all, torch.float32)  # the three heads as one (10, fan_in) product
        return y[:, 0:3], y[:, 3:7], y[:, 7:10]
