"""The reference's stage-1 render and training step (plain PyTorch).

`render` draws a frame of a scene (the dataset's targets, the viewer's
frames); `Step` follows the port's stage-1 step (`engine/train_step.py`):
the deform field at the frame's time and at the paired frame's, the SE(3)
warp with the deltas on scales and rotations, projection, SH, the
compositor with the flow channels, the random background, L1 + SSIM, the
2D and 3D flow losses, and per-group Adam. It runs on the live rows only:
the port's dead rows take no gradient and do not move.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import core

GAUSSIAN_GROUPS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")


def sh_stack(params) -> torch.Tensor:
    rest = params["features_rest"]
    return torch.cat([params["features_dc"][:, None, :], rest.reshape(rest.shape[0], -1, 3)], dim=1)


def camera(frame: dict, device, prev: bool = False):
    c2w = torch.as_tensor(frame["c2w0" if prev else "c2w"], dtype=torch.float32, device=device)
    K = core.intrinsics(frame["fx"], frame["fy"], frame["cx"], frame["cy"], device)
    return c2w, core.viewmat(c2w), K


def deformed(params, deform_w, t: float, quant=None):
    """(means, scales, quats) at time t: the screw warp of the means, the
    deltas added to the linear scales and the normalised quaternions (the
    port's gate arithmetic at gate 1, for the same rounding)."""
    means = params["means"]
    scales = torch.exp(params["scales"])
    quats = params["quats"] / core.safe_norm(params["quats"], keepdim=True)
    screw, d_rot, d_scale = core.deform_field(deform_w, means.detach(), t, quant=quant)
    means_d = core.se3_apply(screw, means)
    return (means + (means_d - means), scales + ((scales + d_scale) - scales), quats + ((quats + d_rot) - quats))


def warped_prev(params, deform_w, t0: float, quant=None):
    base = params["means"]
    screw, _, _ = core.deform_field(deform_w, base.detach(), t0, quant=quant)
    return base + (core.se3_apply(screw, base) - base)


@torch.no_grad()
def render(params, deform_w, frame: dict, background, *, tile: int = 16, sh_degree: int = 3, quant=None):
    """(H, W, 3) rgb of the scene at the frame's camera and time."""
    dev = params["means"].device
    _, vm, K = camera(frame, dev)
    means, scales, quats = deformed(params, deform_w, frame["time"], quant)
    opac = torch.sigmoid(params["opacities"][:, 0])
    w, h = frame["width"], frame["height"]
    m2d, depths, conics, radii = core.project(means, quats, scales, vm, K, w, h)
    colors = core.sh_colors(sh_stack(params), means, vm, sh_degree)
    rgb, alpha = core.composite(m2d, conics, colors, opac, depths, core.tight_radii(radii, opac), w, h, tile=tile)
    return torch.clamp(rgb + (1.0 - alpha) * background, 0.0, 1.0)


def step_loss(params, deform_w, frame: dict, batch: Dict[str, torch.Tensor], background, cfg: dict, quant=None,
              count_walk: bool = False, half: bool = False):
    """The stage-1 loss of one step and its parts. `half` is a planted
    fault: the image losses over the top half of the rows alone."""
    dev = params["means"].device
    w, h = frame["width"], frame["height"]
    c2w, vm, K = camera(frame, dev)
    c2w0, vm0, _ = camera(frame, dev, prev=True)
    means, scales, quats = deformed(params, deform_w, frame["time"], quant)
    means_prev = warped_prev(params, deform_w, frame["time0"], quant)
    opac = torch.sigmoid(params["opacities"][:, 0])
    m2d, depths, conics, radii = core.project(means, quats, scales, vm, K, w, h)
    m2d_prev = core.project(means_prev, quats, scales, vm0, K, w, h)[0]
    colors = core.sh_colors(sh_stack(params), means, vm, cfg["sh_degree"])
    channels = torch.cat([colors, m2d - m2d_prev], dim=-1)
    out = core.composite(m2d, conics, channels, opac, depths, core.tight_radii(radii, opac), w, h,
                         count_walk=count_walk)
    render, alpha = out[0], out[1]
    rgb = torch.clamp(render[..., :3] + (1.0 - alpha) * background, 0.0, 1.0)
    rows = h // 2 if half else h
    gt = batch["image"][:rows]
    l1 = torch.mean(torch.abs(gt - rgb[:rows]))
    s = core.ssim(gt, rgb[:rows])
    total = (1 - cfg["ssim_lambda"]) * l1 + cfg["ssim_lambda"] * (1.0 - s)
    fl2 = core.flow_2d_loss(render[:rows, :, 3:5], batch["flow"][:rows], alpha[:rows])
    total = total + cfg["flow_loss_weight"] * cfg["flow_px_ref"] / max(h, w) * fl2
    alive = torch.ones(means.shape[0], dtype=torch.bool, device=dev)
    target, inb = core.lift_flow(m2d.detach(), batch["depth0"], batch["flow"], core.c2w_opencv(c2w0), K, alive)
    fl3 = core.flow_3d_loss(means_prev, target, inb, radii, alive)
    total = total + cfg["flow_3d_loss_weight"] * fl3
    parts = {"loss": total, "l1": l1, "ssim": s, "flow_2d": fl2, "flow_3d": fl3}
    if count_walk:
        parts["walked_pairs"] = out[2]
    return parts


class Step:
    """Training steps from a start state with zero first moments and the
    second moments `nu` (each leaf's, zero where not given), as the port's
    trainer runs them: the Gaussian groups and one field group (`field`:
    "deform" in stage 1, "control" in stage 2), whose weights
    `loss(params, field_weights, frame, batch, background, ...)` takes.
    `run(frame, batch, background)` returns the loss parts and each leaf's
    gradient, and applies Adam; `grads` returns them alone."""

    def __init__(self, params, field_w, counts: Dict[str, int], lrs: Dict[str, object], max_steps: int,
                 cfg: dict, quant=None, half: bool = False, field: str = "deform", loss=None, nu=None):
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.field_w = {k: v.detach().clone().requires_grad_(True) for k, v in field_w.items()}
        self.field = field
        self.loss = loss or step_loss
        self.mu = {k: torch.zeros_like(v) for k, v in self.leaves().items()}
        nu = nu or {}
        self.nu = {k: nu[k].detach().clone().float() if k in nu else torch.zeros_like(v)
                   for k, v in self.leaves().items()}
        self.counts = dict(counts)
        self.lrs, self.max_steps, self.cfg, self.quant, self.half = lrs, max_steps, cfg, quant, half

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {**self.params, **{f"{self.field}.{k}": v for k, v in self.field_w.items()}}

    def grads(self, frame, batch, background, count_walk: bool = False):
        parts = self.loss(self.params, self.field_w, frame, batch, background, self.cfg, self.quant, count_walk,
                          self.half)
        leaves = self.leaves()
        grads = torch.autograd.grad(parts["loss"], list(leaves.values()), allow_unused=True)
        out = {name: torch.zeros_like(p) if g is None else g for (name, p), g in zip(leaves.items(), grads)}
        return {k: float(v.detach()) if k != "walked_pairs" else v for k, v in parts.items()}, out

    def run(self, frame, batch, background, count_walk: bool = False):
        parts, grads = self.grads(frame, batch, background, count_walk)
        with torch.no_grad():
            for name, p in self.leaves().items():
                group = name if name in GAUSSIAN_GROUPS else self.field
                lr = core.lr_of(group, self.lrs, self.max_steps, self.counts[group])
                core.adam_step(p, grads[name], self.mu[name], self.nu[name], lr, self.counts[group])
            for group in self.counts:
                self.counts[group] += 1
        return parts, grads


def learning_rates(opt: dict) -> Dict[str, object]:
    """Per-group rates of the port's `make_optimizers` for the stage-1
    groups, spatial_lr_scale folded in: a float, or (init, final) decayed
    over max_steps."""
    s = opt["spatial_lr_scale"]
    return {
        "means": (opt["means_lr"] * 5 * s, opt["means_lr_final"] * 5 * s),
        "features_dc": opt["features_dc_lr"],
        "features_rest": opt["features_rest_lr"],
        "opacities": opt["opacities_lr"],
        "scales": opt["scales_lr"],
        "quats": opt["quats_lr"],
        "deform": (opt["deform_lr"] * 5 * s, opt["deform_lr_final"] * s),
        "control": (opt["control_lr"] * 5 * s, opt["control_lr_final"] * s, opt["control_max_steps"]),
    }


def batch_of(frame: dict, images: torch.Tensor, depth: torch.Tensor, flow: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A frame's supervision as the reference reads it from the inputs the
    benchmark made: the uint8 image / 255, the paired frame's depth, the
    interflow."""
    i = frame["index"]
    return {"image": images[i].float() / 255.0, "depth0": depth[frame["prev"]], "flow": flow[i]}
