"""The reference's stage-2 (control) training loss (plain PyTorch),
following the port's `engine/control_train_step.py` and
`models/control_model.py`: the control state (each attribute's mean
displacement under the frozen deform field between the init time and the
frame's time, without gradient), the per-point blend through the cluster
mask, the control field on (means, value), its deltas on the masked
Gaussians, projection, SH, the compositor, the random background and
L1 + SSIM."""

from __future__ import annotations

import torch

from . import core
from .stage1 import camera, sh_stack


def control_state(params, deform_w, mask, t0: float, t1: float):
    with torch.no_grad():
        means = params["means"]
        disp = (core.se3_apply(core.deform_field(deform_w, means, t1)[0], means)
                - core.se3_apply(core.deform_field(deform_w, means, t0)[0], means))
        m = mask.float()
        return torch.einsum("nm,nc->mc", m, disp) / torch.clamp(m.sum(0), min=1.0)[:, None]


def make_loss(deform_w, mask, init_time: float):
    """loss(params, control weights, frame, batch, background, cfg, quant,
    count_walk, half) for Step."""

    def loss(params, control_w, frame, batch, background, cfg, quant=None, count_walk=False, half=False):
        dev = params["means"].device
        w, h = frame["width"], frame["height"]
        _, vm, K = camera(frame, dev)
        d_avg = control_state(params, deform_w, mask, init_time, frame["time"])
        m = mask.float()
        value = (m @ d_avg) / torch.clamp(m.sum(-1, keepdim=True), min=1.0)
        means = params["means"]
        d_xyz, d_rot, d_scale = core.control_field(control_w, means, value, quant=quant)
        sel = mask.any(-1)[:, None].float()
        new_means = means + sel * d_xyz
        scales = torch.exp(params["scales"]) + sel * d_scale
        quats = params["quats"] / core.safe_norm(params["quats"], keepdim=True) + sel * d_rot
        opac = torch.sigmoid(params["opacities"][:, 0])
        m2d, depths, conics, radii = core.project(new_means, quats, scales, vm, K, w, h)
        colors = core.sh_colors(sh_stack(params), new_means, vm, cfg["sh_degree"])
        out = core.composite(m2d, conics, colors, opac, depths, core.tight_radii(radii, opac), w, h,
                             count_walk=count_walk)
        rgb = torch.clamp(out[0] + (1.0 - out[1]) * background, 0.0, 1.0)
        rows = h // 2 if half else h
        gt = batch["image"][:rows]
        l1 = torch.mean(torch.abs(gt - rgb[:rows]))
        s = core.ssim(gt, rgb[:rows])
        parts = {"loss": (1 - cfg["ssim_lambda"]) * l1 + cfg["ssim_lambda"] * (1.0 - s), "l1": l1, "ssim": s}
        if count_walk:
            parts["walked_pairs"] = out[2]
        return parts

    return loss
