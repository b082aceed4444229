"""The multi-GPU training step over a (data x tile) grid of ranks (twin of
`freegaussian_tpu/parallel/sharding.py`), one process per GPU.

  - `data`: one camera (full image) per data group, the DDP analogue.
    Gradients are all-reduced after the backward.
  - `tile`, pixel stage: a data group's ranks render horizontal bands of its
    image (`forward`'s `band_origin_y` / `band_height`).
  - `tile`, primitive stage: the same ranks shard the Gaussian capacity for
    the deform field, projection and SH (`forward`'s
    `primitive_shard_axis`), then all-gather the render attributes into the
    band's pixel stage; the gather's backward reduce-scatters per-Gaussian
    gradients back to their shard.

The loss is the single-GPU step's, split into rank-local terms whose sum
over ranks is the frame mean over the data groups: every cross-rank
quantity inside a term (the SSIM window count, the flow weight sums) is a
detached denominator summed outside the graph, so the plain sum of the
ranks' gradients is the gradient of the loss. SSIM windows that cross a
band boundary see their neighbours' rows through a 5-row ring exchange
(`_halo_rows`, an all-gather of the bands' edge rows, differentiable), and
each band sums the windows whose centre it owns: with band heights that are multiples of the tile size the bands'
tile grids line up with the single-GPU grid, and the loss is the
single-GPU loss.

Parameters stay replicated: every rank applies the same update to
bit-equal parameters, and every rank draws the same background and refine
samples from its copy of one seeded generator. `zero1` shards the Adam
moments of the Gaussian groups over the ranks instead (reduce-scatter the
gradients, update this rank's rows, all-gather the parameters); the
moments then stay sharded in the state.

The processes form the group first (`parallel/distributed.py:
ensure_distributed`); `make_mesh` builds the grid on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..data.cameras import Camera
from ..engine.optimizers import adam_update
from ..engine.train_step import GAUSSIAN_GROUPS, TrainState, draw_background, params_by_group
from ..models.densify import DensifyConfig, refine, update_stats, zero_moment_rows
from ..models.splat_model import SplatConfig, forward, psnr, scale_regularization
from ..models.ssim import ssim_map
from ..ops.flow import flow_supervision_loss, query_3d_gaussian_flow

SSIM_WIN = 11
HALO = SSIM_WIN // 2


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, tile) grid: global rank d * tile + t
    holds data index d and band t; `data_group` holds the ranks of band t,
    `tile_group` the bands of data index d (group ranks in grid order)."""

    data: int
    tile: int
    rank: int
    data_group: Any
    tile_group: Any
    device: torch.device

    @property
    def data_index(self) -> int:
        return self.rank // self.tile

    @property
    def tile_index(self) -> int:
        return self.rank % self.tile


def make_mesh(data: int, tile: int = 1) -> Mesh:
    """The grid over the initialized process group of data * tile ranks.
    Every rank calls it (each subgroup is created on all ranks)."""
    world = dist.get_world_size()
    if world != data * tile:
        raise ValueError(f"a ({data}, {tile}) mesh needs {data * tile} ranks, the process group has {world}")
    rank = dist.get_rank()
    tile_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * tile + t for t in range(tile)])
        if rank // tile == d:
            tile_group = g
    for t in range(tile):
        g = dist.new_group([d * tile + t for d in range(data)])
        if rank % tile == t:
            data_group = g
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    return Mesh(data, tile, rank, data_group, tile_group, device)


def stack_cameras(cameras: Sequence[Camera]) -> Camera:
    """Cameras of one size stacked into one Camera with a leading axis."""
    first = cameras[0]
    return dataclasses.replace(
        first, **{f: torch.stack([getattr(c, f) for c in cameras]) for f in ("c2w", "fx", "fy", "cx", "cy", "time")}
    )


def camera_at(cameras: Camera, i: int) -> Camera:
    """Camera i of a `stack_cameras` stack."""
    return dataclasses.replace(
        cameras, **{f: getattr(cameras, f)[i] for f in ("c2w", "fx", "fy", "cx", "cy", "time")}
    )


def _state_tensors(state: TrainState):
    """Every tensor of a replicated state, in one order on every rank."""
    out = [state.params[k] for k in sorted(state.params)] + [state.alive]
    for field in (state.deform, state.control):
        if field is not None:
            out += list(field.state_dict(keep_vars=True).values())
    for g in sorted(state.opt_states):
        st = state.opt_states[g]
        out += [st.mu[k] for k in sorted(st.mu)] + [st.nu[k] for k in sorted(st.nu)]
    out += [state.densify.xys_grad_norm, state.densify.vis_counts, state.densify.max_2dsize]
    return out


@torch.no_grad()
def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Broadcast rank 0's state (every tensor, the Adam counts, the step and
    the generator) to every rank, in place; returns it."""
    for t in _state_tensors(state):
        if t.dtype == torch.bool:
            buf = t.to(torch.uint8)
            dist.broadcast(buf, src=0)
            t.copy_(buf.bool())
        else:
            dist.broadcast(t.data, src=0)
    ints = torch.tensor([state.step] + [state.opt_states[g].count for g in sorted(state.opt_states)], device=mesh.device)
    dist.broadcast(ints, src=0)
    state.step = int(ints[0])
    for g, c in zip(sorted(state.opt_states), ints[1:].tolist()):
        state.opt_states[g].count = int(c)
    gen = state.generator.get_state().to(mesh.device)
    dist.broadcast(gen, src=0)
    state.generator.set_state(gen.cpu())
    return state


def _halo_rows(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """Extend a (Hs, W, C) band with `halo` rows from each tile neighbour:
    the previous band's last rows above it, the next band's first below it.
    The ring wraps at the frame's outer edges, which gives rows from the
    wrong end there; the caller masks the windows centred outside the frame.
    Every band's edge rows are all-gathered (differentiable: the gradient of
    each received row goes back to its owner) rather than sent point to
    point, which gloo refuses on CUDA tensors (PERF.md §7)."""
    n, t = mesh.tile, mesh.tile_index
    if n == 1:
        return torch.cat([x[-halo:], x, x[:halo]], dim=0)
    from .distributed import all_gather_rows

    edges = all_gather_rows(torch.cat([x[:halo], x[-halo:]], dim=0), mesh.tile_group)  # band b: rows [2 b h, 2 (b + 1) h)
    prv, nxt = (t - 1) % n, (t + 1) % n
    return torch.cat([edges[(2 * prv + 1) * halo:(2 * prv + 2) * halo], x, edges[2 * nxt * halo:(2 * nxt + 1) * halo]], dim=0)


def _band_ssim_parts(pred: torch.Tensor, gt: torch.Tensor, Hs: int, H: int, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, count) of the valid SSIM windows whose centres lie in this band."""
    m = ssim_map(_halo_rows(gt, HALO, mesh), _halo_rows(pred, HALO, mesh), win_size=SSIM_WIN)  # (1, C, Hs, W - 10)
    centers = mesh.tile_index * Hs + torch.arange(Hs, device=pred.device)
    vmask = ((centers >= HALO) & (centers <= H - 1 - HALO)).to(m.dtype).reshape(1, 1, Hs, 1)
    return torch.sum(m * vmask), torch.sum(vmask) * m.shape[1] * m.shape[3]


def _all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of a detached value (outside the graph)."""
    x = x.detach().clone(memory_format=torch.contiguous_format)  # a gradient may be a strided view
    dist.all_reduce(x, op=op, group=group)
    return x


def make_parallel_train_step(
    splat_cfg: SplatConfig,
    densify_cfg: DensifyConfig,
    optimizers: Dict[str, Any],
    num_train_data: int,
    mesh: Mesh,
    image_hw: Tuple[int, int],
    *,
    train_deform: bool = True,
    with_refine: bool = True,
    with_flow: bool = False,
    primitive_sharding: bool = True,
    grad_reduce_dtype: Optional[str] = None,
    zero1: bool = False,
):
    """Build the step. Returns step_fn(state, cams, imgs[, cams0, flows,
    depth0s], sh_degree_now=..., draws=None) -> (state, metrics), called on
    every rank with the same arguments: `cams` stacked (`stack_cameras`, D =
    mesh.data cameras), `imgs` (D, H, W, 3), with `with_flow` also the paired
    cameras, flows (D, H, W, 2) and depth0s (D, H, W, 1). Each rank takes its
    camera and its band; the state (replicated: `replicate_state`) is
    updated in place. `draws` injects the random numbers, as the single
    step's does. Camera optimization and the bilateral grid are not trained
    here, as in the JAX package's multi-chip step.

    H must divide the tile axis; with (H / tile) % tile_size == 0 the band
    tile grids align with the single-GPU grid. `grad_reduce_dtype`
    ("bfloat16") casts gradients for the reduction and back to f32 for Adam.
    `zero1` needs capacity % (data * tile) == 0."""
    H, W = image_hw
    n_tile, n_data = mesh.tile, mesh.data
    if H % n_tile:
        raise ValueError(f"image height {H} must divide the tile axis {n_tile}")
    Hs = H // n_tile
    ndev = n_data * n_tile
    use_flow_2d = with_flow and splat_cfg.flow_loss_weight > 0
    use_flow_3d = with_flow and splat_cfg.flow_3d_loss_weight > 0
    shard_group = mesh.tile_group if primitive_sharding and n_tile > 1 else None
    wire = getattr(torch, grad_reduce_dtype) if grad_reduce_dtype else None

    def reduce_(g: torch.Tensor) -> torch.Tensor:
        """Sum over every rank, on the wire in `grad_reduce_dtype`."""
        g = g.to(wire) if wire is not None else g.clone()
        dist.all_reduce(g)
        return g.float()

    def step_fn(state: TrainState, cams: Camera, imgs: torch.Tensor, *flow_args, sh_degree_now: int = splat_cfg.sh_degree,
                draws: Optional[Dict[str, Any]] = None):
        draws = draws or {}
        d, t = mesh.data_index, mesh.tile_index
        cam = camera_at(cams, d)
        img = imgs[d, t * Hs:(t + 1) * Hs]
        if with_flow:
            cam0 = camera_at(flow_args[0], d)
            flow_full, depth0_full = flow_args[1][d], flow_args[2][d]
        params, alive = state.params, state.alive
        dev = alive.device
        capacity = alive.shape[0]
        if zero1 and capacity % ndev:
            raise ValueError(f"zero1 needs capacity ({capacity}) divisible by the rank count ({ndev})")
        mine = slice(mesh.rank * (capacity // ndev), (mesh.rank + 1) * (capacity // ndev)) if zero1 else slice(None)
        warmed_up = state.step >= splat_cfg.warm_up
        deform = state.deform if train_deform else None

        bg = draw_background(splat_cfg, dev, state.generator, draws)
        sink = torch.zeros((capacity, 2), device=dev, requires_grad=True)
        # the full camera drives projection; the band enters the pixel stage only
        outputs = forward(
            splat_cfg, params, alive, cam,
            deform=deform, sh_degree_now=sh_degree_now, warmed_up=warmed_up, train=True,
            background=bg, means2d_sink=sink, camera0=cam0 if with_flow else None, render_flow=use_flow_2d,
            primitive_shard_axis=shard_group, band_origin_y=t * Hs, band_height=Hs,
        )
        # the frame's loss as a sum over ranks of local terms (module docstring)
        gt, pred = img[..., :3], outputs["rgb"]
        l1_local = torch.sum(torch.abs(gt - pred)) / (H * W * gt.shape[-1])
        s_sum, s_cnt = _band_ssim_parts(pred, gt, Hs, H, mesh)
        total_cnt = torch.clamp(_all_reduce(s_cnt, mesh.tile_group), min=1.0)
        # the constant 1 of (1 - ssim) split evenly over the bands
        main_local = (1 - splat_cfg.ssim_lambda) * l1_local + splat_cfg.ssim_lambda * (1.0 / n_tile - s_sum / total_cnt)
        # replicated parameters: every band adds the same term, so each adds 1/n_tile of it
        frame_local = main_local + scale_regularization(splat_cfg, params, alive, state.step % 10 == 0) / n_tile
        gate = float(warmed_up)
        metrics_extra = {}
        if use_flow_2d:
            w = outputs["accumulation"].detach()
            num_local = torch.sum(w * torch.abs(outputs["flow"] - (-flow_full[t * Hs:(t + 1) * Hs])))
            fl_local = num_local / torch.clamp(_all_reduce(torch.sum(w), mesh.tile_group) * 2.0, min=1.0)
            w2d = splat_cfg.flow_loss_weight
            if splat_cfg.flow_px_ref > 0:
                w2d = w2d * splat_cfg.flow_px_ref / max(H, W)
            frame_local = frame_local + gate * w2d * fl_local
            metrics_extra["flow_2d"] = _all_reduce(fl_local, mesh.tile_group)
        if use_flow_3d:
            # means2d comes back gathered, in full-frame coordinates
            lifted = query_3d_gaussian_flow(
                outputs["means2d"].detach(), depth0_full, flow_full, cam0.c2w_opencv, cam.K, valid=alive
            )
            fl3 = flow_supervision_loss(outputs["means_prev"], lifted, outputs["radii"], alive=alive)
            frame_local = frame_local + gate * splat_cfg.flow_3d_loss_weight * fl3 / n_tile
            metrics_extra["flow_3d"] = fl3.detach()
        loss_local = frame_local / n_data

        groups = params_by_group(params, deform)
        names = [(g, k) for g, ps in groups.items() for k in ps]
        leaves = [groups[g][k] for g, k in names]
        grads = torch.autograd.grad(loss_local, leaves + [sink], allow_unused=True)
        with torch.no_grad():
            # the sink's gradient already carries the 1/n_data frame mean: the
            # sum over ranks assembles the bands and shards and averages the frames
            absgrad = _all_reduce(grads[-1] if grads[-1] is not None else torch.zeros_like(sink))
            radii = _all_reduce(outputs["radii"], op=dist.ReduceOp.MAX)
            grads_by_group = {g: {} for g in groups}
            local = {(g, k): (grad if grad is not None else torch.zeros_like(leaf))
                     for (g, k), grad, leaf in zip(names, grads[:-1], leaves)}
            dense = [(g, k) for g, k in names if not (zero1 and g in GAUSSIAN_GROUPS)]
            if dense:
                # one bucket for every all-reduced gradient (the DDP pattern)
                flat = reduce_(torch.cat([local[n].reshape(-1) for n in dense]))
                for n, part in zip(dense, torch.split(flat, [local[n].numel() for n in dense])):
                    grads_by_group[n[0]][n[1]] = part.view_as(local[n])
            keep = lambda x, a: torch.where(a.reshape((-1,) + (1,) * (x.ndim - 1)), x, torch.zeros_like(x))
            if zero1:
                for k in GAUSSIAN_GROUPS:
                    g_full = local[(k, k)].to(wire) if wire is not None else local[(k, k)]
                    g_shard = g_full.new_empty((capacity // ndev,) + tuple(g_full.shape[1:]))
                    dist.reduce_scatter_tensor(g_shard, g_full.contiguous())
                    st = state.opt_states[k]
                    for part in (st.mu, st.nu):  # moments kept sharded: slice them at the first step
                        if part[k].shape[0] == capacity:
                            part[k] = part[k][mine].clone()
                    p_shard = params[k].detach()[mine].clone()
                    adam_update(optimizers[k], st, {k: p_shard}, {k: keep(g_shard.float(), alive[mine])})
                    dist.all_gather_into_tensor(params[k].data, p_shard)
                dense_groups = {g: ps for g, ps in groups.items() if g not in GAUSSIAN_GROUPS}
            else:
                for k in GAUSSIAN_GROUPS:
                    grads_by_group[k][k] = keep(grads_by_group[k][k], alive)
                dense_groups = groups
            for g, ps in dense_groups.items():
                adam_update(optimizers[g], state.opt_states[g], ps, grads_by_group[g])

            dstate = update_stats(state.densify, radii, absgrad, (H, W))
            refine_info = None
            if with_refine and state.step >= densify_cfg.refine_start and state.step % densify_cfg.refine_every == 0:
                new_params, alive, dstate, refine_info = refine(
                    densify_cfg, params, alive, dstate, state.step, (H, W), num_train_data,
                    generator=state.generator, split_eps=draws.get("split_eps"),
                )
                mask = refine_info["moment_zero_mask"]
                for k in GAUSSIAN_GROUPS:
                    params[k].copy_(new_params[k])
                    zero_moment_rows(state.opt_states[k], mask[mine], params[k][mine])
                if refine_info["reset_opacity_moments"]:
                    st = state.opt_states["opacities"]
                    st.mu = {k: torch.zeros_like(v) for k, v in st.mu.items()}
                    st.nu = {k: torch.zeros_like(v) for k, v in st.nu.items()}

            mean_data = lambda x: _all_reduce(x, mesh.data_group) / n_data
            l1 = _all_reduce(l1_local, mesh.tile_group)
            ssim_v = _all_reduce(s_sum, mesh.tile_group) / total_cnt
            metrics = {
                "loss": _all_reduce(loss_local),
                "main_loss": mean_data((1 - splat_cfg.ssim_lambda) * l1 + splat_cfg.ssim_lambda * (1 - ssim_v)),
                "l1": mean_data(l1),
                "ssim": mean_data(ssim_v),
                "psnr": _all_reduce(psnr(pred.detach(), gt)) / ndev,
                "gaussian_count": alive.sum(),
                "num_isects": int(_all_reduce(torch.as_tensor(outputs["num_isects"], device=dev).long())) // n_data,
            }
            for k, v in metrics_extra.items():
                metrics[k] = mean_data(v)
            if refine_info is not None:
                metrics["refine"] = {k: refine_info[k] for k in ("num_split", "num_dup", "num_culled", "num_alive")}
        state.alive = alive
        state.densify = dstate
        state.step += 1
        return state, metrics

    return step_fn
