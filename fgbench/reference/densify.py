"""The reference's density control (plain PyTorch, float32), for the
program's `models/densify.py`.

The semantics are those of the reference that the program's docstring
cites, FreeGaussian's freegaussian_model.py:369-571 (nerfstudio's
splatfacto):

  - after every step, on the rows the frame sees (3-sigma radius > 0):
    `vis_counts` += 1, `xys_grad_norm` += |absgrad of means2d|, and
    `max_2dsize` = max(itself, radius / max(H, W)); the statistics start at
    zeros, ones and zeros, and start again after every refinement;
  - every `refine_every` steps from `refine_start`, while densifying
    (step < `stop_split_at` and step mod (`reset_alpha_every` x
    `refine_every`) past the training frames and one cadence):
    avg = xys_grad_norm / vis_counts x 0.5 x max(H, W); a row splits when
    its avg is over `densify_grad_thresh` and its largest scale over
    `densify_size_thresh`, or (before `stop_screen_size_at`) when its
    screen size is over `split_screen_size`; a row with avg over the
    threshold and no larger scale is duplicated;
  - a split row gives `n_split_samples` children, mean + R(quat) (exp(scale)
    eps) with eps ~ N(0, I), scales exp(scale) / 1.6, the rest copied, and
    is culled itself; a duplicate is a copy;
  - culling, after the children are appended: opacity under
    `cull_alpha_thresh`, and past `reset_alpha_every` x `refine_every` steps
    a largest scale over `cull_scale_thresh` or (before
    `stop_screen_size_at`) a screen size over `cull_screen_size`; past
    `stop_split_at` culling alone goes on
    (`continue_cull_post_densification`);
  - the opacity reset at step mod (`reset_alpha_every` x `refine_every`) =
    `refine_every`: opacities clamped to logit(2 `cull_alpha_thresh`) and
    the opacities' Adam moments zeroed;
  - Adam's rows of culled Gaussians are removed and new rows start at zero.

Departures from it, each the program's layout, so that the program's
state can be compared slot by slot:

  1. The Gaussians live in a fixed-capacity table with an `alive` mask.
     The children go into the dead slots in slot order: the first sample
     of every placed split row in row order, then the second sample, then
     the duplicates; children past the last free slot are dropped and
     counted (`num_dropped`). The reference appends and drops nothing.
  2. The reference culls after appending, so a child that meets a cull
     criterion (low opacity; past the warm-up a scale over
     `cull_scale_thresh`) is appended and culled at once: here it is never
     placed. The live set is the same; `num_culled` counts culled source
     rows (split sources included), not such children.
  3. The split samples' normal draws come as two (capacity, 3) arrays, row
     i's sample k drawn at row i of array k (`eps`); the reference draws
     (k n_splits, 3) over the split rows alone. A run hands both the same
     numbers.
  4. Removing Adam's rows of culled Gaussians and appending zero rows
     becomes zeroing the moment rows of culled and newly placed slots
     (`moment_zero`).

One rule follows the cited model where it may differ from splatfacto:
before `stop_screen_size_at` a row splits when it is (high-gradient and
large) or screen-large, as SURVEY.md's account of
freegaussian_model.py:524-560 has it ("large & high-grad, or
big-on-screen"). Splatfacto ORs the screen-size term in and then gates the
whole on the gradient (`splits &= high_grads`), so a screen-large row with
a low gradient splits here and not there. Neither source is in the
repository to check against; past step 4000, as in every cell, the two
rules agree.

`accumulate` and `refine` take the configuration's density settings as a
dict (`SETTINGS`' keys) and never import the program.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import core

GROUPS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")
SETTINGS = ("refine_start", "refine_every", "reset_alpha_every", "stop_split_at", "stop_screen_size_at",
            "densify_grad_thresh", "densify_size_thresh", "n_split_samples", "cull_alpha_thresh",
            "cull_scale_thresh", "cull_screen_size", "split_screen_size", "continue_cull_post_densification")
SIZE_FAC = 1.6


def settings_of(model: dict) -> dict:
    """The density settings of a configuration's `pipeline.model` group."""
    return {k: model[k] for k in SETTINGS}


def fresh_statistics(capacity: int, device) -> Dict[str, torch.Tensor]:
    return {"xys_grad_norm": torch.zeros(capacity, device=device), "vis_counts": torch.ones(capacity, device=device),
            "max_2dsize": torch.zeros(capacity, device=device)}


def accumulate(stats: Dict[str, torch.Tensor], radii: torch.Tensor, absgrad: torch.Tensor,
               last_size: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """One step's statistics added to `stats` (new tensors): `radii` (N,)
    the 3-sigma radii, `absgrad` (N, 2) the absolute means2d gradient."""
    seen = torch.nonzero(radii > 0)[:, 0]
    out = {k: v.clone() for k, v in stats.items()}
    out["vis_counts"][seen] += 1.0
    out["xys_grad_norm"][seen] += torch.sqrt((absgrad[seen].float() ** 2).sum(-1))
    size = radii[seen].float() / float(max(last_size))
    out["max_2dsize"][seen] = torch.maximum(out["max_2dsize"][seen], size)
    return out


def absgrad_composite(means2d, conics, colors, opac, depths, radii_px, width: int, height: int, *, tile: int = 16,
                      tiles_per_chunk: int = 32, count_walk: bool = False, sink: Optional[list] = None):
    """`core.composite`, keeping each chunk's gathered means2d, (T, K, 2)
    over (tile, Gaussian) pairs, and their Gaussian ids in `sink`: after the
    backward, each pair's gradient is the sum over its tile's pixels, and
    `absgrad` sums their absolute values by Gaussian (AbsGS, per tile)."""
    dev = means2d.device
    tw, th = -(-width // tile), -(-height // tile)
    with torch.no_grad():
        gids, counts = core._bin(means2d.detach(), depths.detach(), radii_px, tile, tw, th)
        offsets = torch.cumsum(counts, 0) - counts
        counts_h, offsets_h = counts.tolist(), offsets.tolist()
    P, C = tile * tile, colors.shape[-1]
    renders, alphas, walked = [], [], 0
    for c0 in range(0, tw * th, tiles_per_chunk):
        tiles = list(range(c0, min(c0 + tiles_per_chunk, tw * th)))
        K, T = max(counts_h[t] for t in tiles), len(tiles)
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
        pairs = means2d[idx]
        if sink is not None and pairs.requires_grad:
            pairs.retain_grad()
            sink.append((pairs, idx, valid))
        out = core._RecomputedBlock.apply(pairs, conics[idx], opac[idx], colors[idx], valid, ox, oy, tile, count_walk)
        renders.append(out[0])
        alphas.append(out[1])
        if count_walk:
            walked += int(out[2])
    r = torch.cat(renders).reshape(th, tw, tile, tile, C).permute(0, 2, 1, 3, 4).reshape(th * tile, tw * tile, C)
    a = torch.cat(alphas).reshape(th, tw, tile, tile).permute(0, 2, 1, 3).reshape(th * tile, tw * tile)
    res = (r[:height, :width], a[:height, :width, None])
    return res + (walked,) if count_walk else res


def absgrad(sink: list, n: int) -> torch.Tensor:
    """(n, 2): the per-tile absolute means2d gradients kept by
    `absgrad_composite`, summed by Gaussian."""
    out = None
    for pairs, idx, valid in sink:
        g = torch.where(valid[..., None], pairs.grad.abs(), torch.zeros_like(pairs.grad))
        out = (torch.zeros((n, 2), device=g.device) if out is None else out).index_add(0, idx.reshape(-1),
                                                                                      g.reshape(-1, 2))
    return out


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of (N, 4) unit quaternions (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def split_children(params: Dict[str, torch.Tensor], rows: torch.Tensor, eps: torch.Tensor,
                   dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One sample of each split row in `rows` (its draws `eps`, (len, 3)):
    mean + R(quat) (exp(scale) eps), scales exp(scale) / 1.6, the rest
    copied. `dtype` is the arithmetic's precision (the results in f32)."""
    quats = params["quats"][rows].to(dtype)
    quats = quats / torch.sqrt((quats * quats).sum(-1, keepdim=True))
    scales = torch.exp(params["scales"][rows].to(dtype))
    offset = torch.bmm(quat_rotmat(quats), (scales * eps.to(dtype))[..., None])[..., 0]
    out = {k: params[k][rows].clone() for k in GROUPS}
    out["means"] = (params["means"][rows].to(dtype) + offset).float()
    out["scales"] = torch.log(scales / SIZE_FAC).float()
    return out


def decisions(s: dict, params: Dict[str, torch.Tensor], alive: torch.Tensor, stats: Dict[str, torch.Tensor],
              step: int, last_size: Tuple[int, int], num_train: int) -> Dict[str, torch.Tensor]:
    """The boolean decisions of a refinement at `step`, by slot: `split`,
    `dup`, `cull` (culled source rows), and which children would survive
    the cull after appending (`split_kept`, `dup_kept`)."""
    interval = s["reset_alpha_every"] * s["refine_every"]
    densify = step < s["stop_split_at"] and step % interval > num_train + s["refine_every"]
    cull_on = densify or (step >= s["stop_split_at"] and s["continue_cull_post_densification"])
    screen = step < s["stop_screen_size_at"]
    post_warmup = step > interval
    largest = torch.exp(params["scales"]).max(dim=-1).values
    avg = stats["xys_grad_norm"] / stats["vis_counts"] * 0.5 * max(last_size)
    high = avg > s["densify_grad_thresh"]
    split = high & (largest > s["densify_size_thresh"])
    if screen:
        split = split | (stats["max_2dsize"] > s["split_screen_size"])
    split = alive & split & densify
    dup = alive & high & (largest <= s["densify_size_thresh"]) & densify
    faint = torch.sigmoid(params["opacities"][:, 0]) < s["cull_alpha_thresh"]
    cull = faint
    if post_warmup:
        huge = largest > s["cull_scale_thresh"]
        if screen:
            huge = huge | (stats["max_2dsize"] > s["cull_screen_size"])
        cull = cull | huge
    cull = alive & (cull | split) & cull_on
    # a child keeps its source's opacity; its scale is the source's (a
    # duplicate) or / 1.6 (a split sample); its screen size starts at 0
    child_huge_split = (largest / SIZE_FAC > s["cull_scale_thresh"]) if post_warmup else torch.zeros_like(faint)
    child_huge_dup = (largest > s["cull_scale_thresh"]) if post_warmup else torch.zeros_like(faint)
    return {"split": split, "dup": dup, "cull": cull, "split_kept": split & ~(faint | child_huge_split),
            "dup_kept": dup & ~(faint | child_huge_dup)}


def refine(s: dict, params: Dict[str, torch.Tensor], alive: torch.Tensor, stats: Dict[str, torch.Tensor], step: int,
           last_size: Tuple[int, int], num_train: int, eps: Tuple[torch.Tensor, ...], dtype=torch.float32) -> dict:
    """One refinement of the capacity table. Returns the new `params` and
    `alive`, the decisions (`decisions`), `placed` (the slots that took a
    child), `moment_zero` (the slots whose Adam rows restart),
    `reset_opacity_moments`, and the counts `num_split`, `num_dup`,
    `num_culled`, `num_alive`, `num_dropped` (ints). `dtype` below float32
    is a control: the decisions and the children computed from the
    parameters and statistics rounded to it (the table's kept rows stay
    as they are)."""
    if dtype != torch.float32:
        rounded = lambda t: t.to(dtype).float()  # noqa: E731
        d = decisions(s, {k: rounded(v) for k, v in params.items()}, alive,
                      {k: rounded(v) for k, v in stats.items()}, step, last_size, num_train)
    else:
        d = decisions(s, params, alive, stats, step, last_size, num_train)
    kept = alive & ~d["cull"]
    free = torch.nonzero(~kept)[:, 0]  # dead slots, in slot order
    split_rows = torch.nonzero(d["split_kept"])[:, 0]
    dup_rows = torch.nonzero(d["dup_kept"])[:, 0]
    children = [split_children(params, split_rows, eps[k][split_rows], dtype) for k in range(s["n_split_samples"])]
    children.append({k: params[k][dup_rows].clone() for k in GROUPS})
    new = {k: torch.cat([c[k] for c in children]) for k in GROUPS}
    n_new = new["means"].shape[0]
    n_placed = min(n_new, free.shape[0])
    slots = free[:n_placed]
    out = {k: v.detach().clone() for k, v in params.items()}
    for k in GROUPS:
        out[k][slots] = new[k][:n_placed]
    new_alive = kept.clone()
    new_alive[slots] = True
    placed = torch.zeros_like(alive)
    placed[slots] = True
    interval = s["reset_alpha_every"] * s["refine_every"]
    reset = step < s["stop_split_at"] and step % interval == s["refine_every"]
    if reset:
        out["opacities"] = torch.clamp(out["opacities"], max=torch.logit(torch.tensor(2.0 * s["cull_alpha_thresh"])).item())
    return {
        **d, "params": out, "alive": new_alive, "placed": placed, "moment_zero": d["cull"] | placed,
        "reset_opacity_moments": reset, "num_split": int(d["split"].sum()), "num_dup": int(d["dup"].sum()),
        "num_culled": int(d["cull"].sum()), "num_alive": int(new_alive.sum()), "num_dropped": n_new - n_placed,
    }
