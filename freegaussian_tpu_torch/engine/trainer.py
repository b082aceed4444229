"""Trainer (twin of `freegaussian_tpu/engine/trainer.py`): the training-loop
shell of the `train` verb. It owns setup (dataparser -> datamanager ->
Gaussians -> fields -> optimizers -> state), the step loop with the
reference's schedules (progressive downscale phases, the SH-degree schedule,
eval / save / log cadences), checkpoints and metric logging
(`metrics.jsonl`: psnr, loss, gaussian_count, steps_per_sec, the fields the
reference instruments, freegaussian_pipeline.py:128-156).

The step (`engine/train_step.py`) updates the state in place. As in the JAX
package, the binning is capacity-bounded: the capacity starts at
`isect_capacity_factor` slots per live Gaussian and the self-tuner
(`_maybe_grow_isect_capacity`) doubles it near overflow and shrinks it after
a stretch of low readings. With `scan_chunk` > 1 training runs in chunks of
up to that many steps over a device arena of the frames (the JAX package's
`_train_scan`, which runs a chunk as one `lax.scan` dispatch): on the card
each chunk is CUDA-graph replays of the step (`_ChunkRunner`: one graph per
downscale phase, SH degree, capacity and step variant, captured after an
eager warm-up step, with no host synchronisation inside the chunk), on the
CPU the same steps run eagerly. `eval_all` sweeps the eval split as the JAX
package's does: without LPIPS or image dumps, over a device arena of
frames of one size (`_eval_arena`), it runs render + PSNR + SSIM for every
frame with no host synchronisation between frames (`_EvalSweep`: on the card
one CUDA graph of a frame, replayed once a frame; on the CPU the same frame
body run eagerly), else it loops frame by frame.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.cameras import Camera
from ..data.datamanager import DeviceArena, FullImageDatamanager
from ..data.dataparsers import PARSERS, ParsedDataset
from ..models.bilagrid import init_bilateral_grids
from ..models.camera_opt import init_camera_opt
from ..models.densify import DensifyConfig
from ..models.gaussians import init_gaussians
from ..models.splat_model import SplatConfig, forward, make_control_field, make_deform_field, psnr, sh_degree_to_use
from ..models.ssim import ssim
from ..ops import adam_cuda, mlp_cuda, rasterize_cuda
from ..ops.math import resize_image
from ..utils import profiling
from ..utils.profiling import profile_section
from .checkpoints import load_checkpoint, save_checkpoint
from .optimizers import OptimizersConfig, adam_scalars, make_optimizers
from .train_step import create_train_state, make_train_step, state_metrics

# Per-slot bytes of the buffers a training step sizes by the binning's
# capacity, counted at the most channels the compositor takes (8): the
# binning's int64 slot arrays, sort keys and permutation (~128), the
# backward's rows (4 (8 + 8)) and the reduction's sorted rows, its f64
# transpose, prefix sum and padded copy (4 (8 + 8) + 3 x 8 (8 + 8)); the
# backward's per-quadrant scratch (4 (6 + 8) a quadrant) comes on top.
ISECT_SLOT_BYTES = 128 + 2 * 4 * 16 + 3 * 8 * 16


@dataclasses.dataclass
class TrainerConfig:
    data: str = ""
    dataparser: str = "synthetic"
    output_dir: str = "outputs"
    experiment_name: str = "freegaussian"
    max_num_iterations: int = 30000
    steps_per_save: int = 2000
    steps_per_eval_image: int = 100
    steps_per_eval_all_images: int = 1000
    eval_all_max_images: Optional[int] = None
    """cap on images per in-training eval_all sweep (None = whole split)"""
    steps_per_log: int = 10
    halt_on_nan: bool = True
    """stop training with a diagnostic when the logged loss or the
    parameters go non-finite (a poisoned state never recovers)"""
    eval_dump_dir: str = ""
    """when set, in-training eval_all sweeps also write gt|pred side-by-side
    PNGs here (the reference's eval image dumps, freegaussian_pipeline.py:144)"""
    vis: str = ""
    """metric sinks: "" (jsonl only), "tensorboard" (also event files, when
    the writer can be made), "viewer+tensorboard" (also the live HTTP viewer)"""
    viewer_port: int = 7007
    scan_chunk: int = 0
    """> 1: train in chunks of up to this many steps over a device arena of
    the frames, with the per-step loop's frame order and step math. On the
    card a chunk is CUDA-graph replays of the step with no host
    synchronisation inside it; metrics come back once per chunk and are
    logged at the steps_per_log cadence afterwards. Chunks break at the
    downscale and SH-degree phase changes and at every eval and save cadence
    point (the JAX package's `lax.scan` chunks, which pay one dispatch a
    chunk)."""
    capacity: int = 1 << 19
    num_random: int = 50000
    """random-init Gaussian count when the dataset has no seed points"""
    seed: int = 42
    splat: SplatConfig = dataclasses.field(default_factory=SplatConfig)
    densify: DensifyConfig = dataclasses.field(default_factory=DensifyConfig)
    optimizers: OptimizersConfig = dataclasses.field(default_factory=OptimizersConfig)
    dataparser_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


def downscale_phase(cfg: SplatConfig, step: int) -> int:
    return int(2 ** max(cfg.num_downscales - step // cfg.resolution_schedule, 0))


def _parse_splits(config: TrainerConfig):
    """(train split, eval split or None when the dataset has none)."""
    parser = PARSERS[config.dataparser]
    parsed = parser(Path(config.data), "train", **config.dataparser_kwargs)
    try:
        eval_parsed = parser(Path(config.data), "val", **config.dataparser_kwargs)
    except (OSError, IndexError, KeyError, ValueError):  # no val split (a missing file, an empty split)
        eval_parsed = None
    return parsed, eval_parsed


class Trainer:
    def __init__(self, config: TrainerConfig, parsed: Optional[ParsedDataset] = None, *, device="cuda"):
        from ..device import resolve_device

        self.device = dev = resolve_device(device)
        if dev.type == "cuda":
            # f32 products stay full f32 (the JAX package pins its default
            # matmul precision to float32 for the same reason)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.generator = torch.Generator(device=dev).manual_seed(config.seed)
        init_gen = torch.Generator().manual_seed(config.seed + 1)  # CPU draws of the field inits

        if parsed is None:
            parsed, self.eval_parsed = _parse_splits(config)
        else:
            self.eval_parsed = None
        self.parsed = parsed
        self.datamanager = FullImageDatamanager(parsed, seed=config.seed, device=dev)
        self.eval_datamanager = FullImageDatamanager(self.eval_parsed, device=dev) if self.eval_parsed else None

        params, alive = init_gaussians(
            config.capacity,
            generator=self.generator,
            seed_points=parsed.seed_points,
            num_random=min(config.num_random, config.capacity // 2),
            sh_degree=config.splat.sh_degree,
            device=dev,
        )
        self._isect_shrinks = 0
        self._isect_low_streak = 0
        self._isect_recent: List[float] = []
        self._isect_last_rebuild: Optional[int] = None
        if config.splat.isect_capacity is None:
            # size the binning off the live Gaussians, not the padded
            # capacity; the self-tuner grows or shrinks it from there
            cap0 = max(config.splat.isect_capacity_factor * max(int(alive.sum()), 1), 1 << 14)
            config = dataclasses.replace(config, splat=dataclasses.replace(config.splat, isect_capacity=cap0))
            self.config = config
        deform = make_deform_field(config.splat).reset_parameters(init_gen, config.splat.deform_head_init_scale)
        self.control = make_control_field(config.splat).reset_parameters(init_gen).to(dev)
        # SO3xR3 adjustments and bilateral grids, one per training image, when enabled
        camera_opt = bilagrid = None
        if config.splat.camera_optimizer_mode != "off":
            camera_opt = init_camera_opt(len(self.datamanager), device=dev)
        if config.splat.use_bilateral_grid:
            bilagrid = init_bilateral_grids(len(self.datamanager), device=dev)
        self.optimizers = make_optimizers(config.optimizers)
        self._arenas: Dict[int, DeviceArena] = {}
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0, "replayed_launches": {}, "kernel_nodes": {}}
        self.eval_graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}
        self._eval_arena_cache: Optional[tuple] = None
        self._eval_sweep_cache: Optional[tuple] = None
        self.state = create_train_state(
            params, alive, deform.to(dev), self.optimizers, generator=self.generator,
            camera_opt=camera_opt, bilagrid=bilagrid,
        )
        self._rebuild_step_fn()

        self.out_dir = Path(config.output_dir) / config.experiment_name
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_log = self.out_dir / "metrics.jsonl"
        self.tb_writer = None
        if "tensorboard" in config.vis:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb_writer = SummaryWriter(str(self.out_dir / "tb"))
            except Exception as e:  # noqa: BLE001 - any failure to make the writer is a warning, as in the JAX package
                warnings.warn(f"tensorboard writer unavailable: {e}")
        self._viewer = None  # started by train(): a subclass's render state is set after __init__

    # ------------------------------------------------------------------
    def _rebuild_step_fn(self) -> None:
        """The stage-1 step; ControlTrainer builds its stage-2 step. Drops
        the chunk runners: their graphs hold the old capacity's buffers."""
        self.step_fn = make_train_step(
            self.config.splat, self.config.densify, self.optimizers, num_train_data=len(self.datamanager)
        )
        self._runners: Dict[tuple, "_ChunkRunner"] = {}

    # the step as the chunk runner drives it; ControlTrainer overrides these
    def _step_variant(self, step: int) -> tuple:
        """The host-side flags of step `step`'s math (one graph each): the
        warm-up gate and, where it applies, the scale regularization."""
        splat = self.config.splat
        return (step >= splat.warm_up, splat.use_scale_regularization and step % 10 == 0)

    def _step_core(self, camera, camera0, batch, sh_deg: int, frame, variant: tuple, scalars):
        warmed_up, scale_reg = variant
        return self.step_fn.core(
            self.state, camera, batch, sh_deg, camera0, {}, frame,
            warmed_up=warmed_up, apply_scale_reg=scale_reg, scalars=scalars,
        )

    def _metric_groups(self):
        return self.step_fn.groups(self.state)

    def _refine_at(self, step: int, last_size):
        return self.step_fn.refine(self.state, step, last_size, {})

    @torch.no_grad()
    def _render_rgb(self, camera: Camera) -> torch.Tensor:
        return self._eval_scan_render()(self.state, camera)

    def _eval_scan_render(self):
        """render(state, camera) -> rgb, the eval render of `_render_rgb`
        and of the eval sweep; ControlTrainer overrides it to render through
        the control model."""
        cfg = self.config  # held by the closure, so `_eval_scan_key`'s id stays its own

        def render(state, camera):
            splat = cfg.splat
            return forward(
                splat, state.params, state.alive, camera, deform=state.deform, sh_degree_now=splat.sh_degree,
                warmed_up=state.step >= splat.warm_up, train=False,
            )["rgb"]

        return render

    def _eval_scan_key(self) -> tuple:
        """Identities of every object the `_eval_scan_render` closure
        captures: the sweep cache key must change when any of them is
        replaced, or a cached sweep renders stale captures. Subclasses whose
        render captures more extend it."""
        return (id(self.config),)

    def viewer_render_fn(self):
        """render_fn(camera, atrb_values|None) -> (H, W, 3) rgb over the
        current state (live during training)."""

        def render_fn(camera, atrb_values=None):
            del atrb_values  # stage 1 has no control sliders
            return self._render_rgb(camera)

        return render_fn

    def viewer_num_attributes(self) -> int:
        return 0  # stage 1 has no control sliders

    def start_viewer(self, port: int = 7007, width: int = 480, height: int = 360, host: str = "0.0.0.0"):
        """Background HTTP viewer over the live model; returns the server."""
        from ..viewer.server import ViewerServer

        server = ViewerServer(
            self.viewer_render_fn(), num_attributes=self.viewer_num_attributes(),
            width=width, height=height, port=port, host=host, device=self.device,
        )
        server.start_background()
        print(f"viewer: http://localhost:{server.port}/")
        return server

    def _log_metrics(self, row: Dict[str, float], step: int, prefix: str = "train") -> None:
        with open(self.metrics_log, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self.tb_writer is not None:
            for k, v in row.items():
                if isinstance(v, (int, float)) and k != "step":
                    self.tb_writer.add_scalar(f"{prefix}/{k}", v, step)

    # ------------------------------------------------------------------
    def _downscale_batch(self, camera: Camera, batch, d: int):
        if d == 1:
            return camera, batch
        out = dict(batch)
        out["image"] = resize_image(batch["image"], d)
        if "flow" in out:
            out["flow"] = resize_image(out["flow"], d) / d
        if "depth0" in out:
            out["depth0"] = resize_image(out["depth0"], d)
        if "mask" in out:
            # area-downsample the float mask, then re-binarize: a pixel stays
            # masked out unless its full-res window was mostly foreground
            out["mask"] = (resize_image(out["mask"], d) > 0.5).to(out["mask"].dtype)
        if "atrb_mask" in out:
            out["atrb_mask"] = resize_image(out["atrb_mask"].float(), d) > 0.5
        return camera.downscaled(d), out

    def _dispatch_step(self, i: int, idx: int, camera: Camera, batch):
        """One stage-1 step: the downscale phase, the flow batch, the SH
        degree; ControlTrainer overrides it with the stage-2 step so both
        stages share the cadence loop."""
        cfg = self.config
        use_flow = cfg.splat.flow_loss_weight > 0 or cfg.splat.flow_3d_loss_weight > 0
        d = downscale_phase(cfg.splat, i)
        camera, batch = self._downscale_batch(camera, batch, d)
        camera0 = None
        if use_flow:
            # camera0 and (possibly zero-filled) flow entries on every frame;
            # per-frame validity gates the losses numerically (train_step.py)
            camera0 = self.datamanager.camera0(idx)
            if d > 1:
                camera0 = camera0.downscaled(d)
            self._fill_flow_batch(batch, camera.height, camera.width)
        return self.step_fn(self.state, camera, batch, sh_degree_to_use(cfg.splat, i), camera0=camera0, cam_idx=idx)

    def _fill_flow_batch(self, batch, h: int, w: int) -> None:
        """Zero-fill a frame's missing flow (and, with the 3D flow loss,
        depth0) and set their 0/1 validity gates, in place."""
        dev = self.device
        if "flow" not in batch:
            batch["flow"] = torch.zeros((h, w, 2), device=dev)
            batch["flow_valid"] = torch.tensor(0.0, device=dev)
        else:
            batch["flow_valid"] = torch.tensor(1.0, device=dev)
        if self.config.splat.flow_3d_loss_weight > 0:
            if "depth0" not in batch:
                batch["depth0"] = torch.zeros((h, w, 1), device=dev)
                batch["depth0_valid"] = torch.tensor(0.0, device=dev)
            else:
                batch["depth0_valid"] = torch.tensor(1.0, device=dev)

    def _device_dataset(self, d: int) -> DeviceArena:
        """Every frame at downscale d stacked on the device, with the
        per-step path's batch policy (`_dispatch_step`): zero-filled flow and
        depth with their gates when the flow losses are on (else no flow
        keys), an all-ones mask where any frame has a mask, and none of the
        keys the losses never read. Built once per downscale phase."""
        cache = self._arenas
        if d in cache:
            return cache[d]
        cfg = self.config
        use_flow = cfg.splat.flow_loss_weight > 0 or cfg.splat.flow_3d_loss_weight > 0
        dm = self.datamanager
        any_mask = any(f.mask is not None for f in dm.frames)
        cams, cams0, batches = [], [], []
        for idx in range(len(dm)):
            camera, batch = self._downscale_batch(*dm.get_batch(idx), d)
            h, w = camera.height, camera.width
            if use_flow:
                self._fill_flow_batch(batch, h, w)
                cams0.append(dm.camera0(idx).downscaled(d))
            else:
                batch.pop("flow", None)
                batch.pop("depth0", None)
            if any_mask and "mask" not in batch:
                batch["mask"] = torch.ones((h, w, 1), device=self.device)
            batch.pop("atrb_mask", None)
            batch.pop("mask_valid", None)
            cams.append(camera)
            batches.append(batch)
        cache[d] = DeviceArena.stack(cams, cams0 if use_flow else None, batches)
        return cache[d]

    def _maybe_start_viewer(self) -> None:
        if "viewer" in self.config.vis and self._viewer is None:
            self._viewer = self.start_viewer(port=self.config.viewer_port)

    # ------------------------------------------------------------------
    def _isect_capacity(self) -> int:
        splat = self.config.splat
        if splat.isect_capacity is not None:
            return splat.isect_capacity
        return splat.isect_capacity_factor * self.config.capacity

    def _maybe_grow_isect_capacity(self, metrics) -> None:
        """The JAX trainer's capacity self-tuner, decision for decision: warn
        on overflow (the binning dropped the deepest tiles of the last
        Gaussians), double the capacity above 85% (up to
        `_isect_capacity_ceiling`), and after 10 readings in a row under 35%
        shrink it to 1.35x the largest of the last 10 readings (floor 2^14)
        once 1500 steps have passed since the last rebuild. A change
        rebuilds the step (and drops its graphs)."""
        if "num_isects" not in metrics:
            return
        cap = self._isect_capacity()
        num = float(metrics["num_isects"])
        with profile_section("tuner", reading=num, capacity=cap) as span:
            if num > cap:
                warnings.warn(
                    f"intersection overflow: {int(num)} > capacity {cap}; the deepest intersections of the largest "
                    "Gaussians were DROPPED this step (capacity is being grown)"
                )
            new_cap = None
            low = 0 < num < 0.35 * cap
            self._isect_low_streak = self._isect_low_streak + 1 if low else 0
            self._isect_recent = (self._isect_recent + [num])[-10:]
            since = self.state.step - (self._isect_last_rebuild if self._isect_last_rebuild is not None else -(1 << 30))
            if num > 0.85 * cap:
                new_cap = 2 * cap
                ceiling = self._isect_capacity_ceiling()
                if new_cap > ceiling:
                    new_cap = ceiling if cap < ceiling else None
                    warnings.warn(
                        f"intersection capacity clamped at the ceiling {ceiling} (measured {int(num)}): the step's "
                        "per-slot buffers must fit the device. Deepest intersections of the largest Gaussians will "
                        "be dropped while the scene stays this dense."
                    )
            elif low and self._isect_low_streak >= 10 and cap > (1 << 14) and since >= 1500:
                # headroom over the recent maximum, not the instant reading: the
                # scheduled opacity resets spike the count for ~100 steps
                new_cap = max(int(1.35 * max(self._isect_recent)), 1 << 14)
                if new_cap >= cap:
                    new_cap = None
                self._isect_shrinks += 1
            if new_cap is not None:
                self.config = dataclasses.replace(
                    self.config, splat=dataclasses.replace(self.config.splat, isect_capacity=new_cap)
                )
                self._isect_last_rebuild = int(self.state.step)
                with profile_section("tuner.rebuild", capacity=new_cap):
                    self._rebuild_step_fn()
            span.note(decision="keep" if new_cap is None else "grow" if new_cap > cap else "shrink")

    def _isect_capacity_ceiling(self) -> int:
        """The largest capacity whose per-slot step buffers fit half the
        device's memory (`ISECT_SLOT_BYTES` plus the backward's scratch at
        the tile size), and below 2^31 (the kernels' int slot indices). The
        JAX package's ceiling is the TPU's scalar memory for its segment
        tables, which the port does not have."""
        splat = self.config.splat
        slot_bytes = ISECT_SLOT_BYTES + rasterize_cuda.quadrants(splat.tile_size) * 4 * (6 + 8)
        if self.device.type == "cuda":
            mem = torch.cuda.get_device_properties(self.device).total_memory
        else:
            mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return max(min(mem // 2 // slot_bytes, (1 << 31) - 1), 1 << 15)

    # ------------------------------------------------------------------
    def _train_scan(self, n: int) -> Dict[str, float]:
        """`n` steps in chunks of up to `scan_chunk` (the JAX trainer's
        `_train_scan`): each chunk is one downscale phase and SH degree and
        ends at the next eval or save cadence point; frames follow the
        per-step loop's order; the metrics are logged at the steps_per_log
        cadence after the chunk, the capacity tuner reads the chunk's peak,
        and a non-finite loss or state halts with the step."""
        cfg = self.config
        start = int(self.state.step)
        end = start + n
        last_metrics: Dict[str, float] = {}
        win_t, win_step = time.time(), start
        i = start
        while i < end:
            profiling.set_chunk(i)
            splat = self.config.splat
            d = downscale_phase(splat, i)
            sh_deg = sh_degree_to_use(splat, i)
            stop = min(i + cfg.scan_chunk, end)
            # a chunk is one downscale phase and one SH degree
            if downscale_phase(splat, stop - 1) != d:
                stop = min(stop, (i // splat.resolution_schedule + 1) * splat.resolution_schedule)
            if sh_degree_to_use(splat, stop - 1) != sh_deg:
                stop = min(stop, (i // splat.sh_degree_interval + 1) * splat.sh_degree_interval)
            # cadence points land on chunk boundaries
            for cad in (cfg.steps_per_eval_all_images, cfg.steps_per_eval_image, cfg.steps_per_save):
                if cad:
                    stop = min(stop, (i // cad + 1) * cad)
            frames = self.datamanager.draw_indices(stop - i)
            stacked = self._chunk_runner(d, sh_deg).run(i, frames)
            with profile_section("chunk.log"):
                now = time.time()
                sps = (stop - win_step) / max(now - win_t, 1e-9)
                for s in range(i, stop):
                    if s % cfg.steps_per_log == 0:
                        row = {k: float(v[s - i]) for k, v in stacked.items()}
                        row["step"] = s
                        row["steps_per_sec"] = sps
                        last_metrics = row
                        self._log_metrics(row, s)
            win_t, win_step = now, stop
            # the tuner reads the chunk's peak (an overflow inside a chunk is
            # seen at its end, as the per-step loop sees it at the next log)
            self._maybe_grow_isect_capacity({"num_isects": float(np.max(stacked["num_isects"]))})
            bad = ~np.isfinite(stacked["loss"]) | (stacked["params_finite"] == 0)
            if cfg.halt_on_nan and bad.any():
                raise FloatingPointError(
                    f"non-finite loss or params inside the chunk [{i}, {stop}) (first at step {i + int(np.argmax(bad))});"
                    " training halted: see TrainerConfig.halt_on_nan"
                )
            i = stop
            if cfg.steps_per_eval_all_images and i % cfg.steps_per_eval_all_images == 0:
                ev = self.eval_all(
                    max_images=cfg.eval_all_max_images,
                    dump_dir=Path(cfg.eval_dump_dir) / f"step_{i:09d}" if cfg.eval_dump_dir else None,
                )
                ev["step"] = i
                ev["eval"] = "all"
                self._log_metrics(ev, i, "eval")
                win_t, win_step = time.time(), i
            elif cfg.steps_per_eval_image and i % cfg.steps_per_eval_image == 0:
                ev = self.eval_one(i)
                if ev is not None:
                    self._log_metrics(ev, i, "eval_image")
                win_t, win_step = time.time(), i
            if cfg.steps_per_save and i % cfg.steps_per_save == 0:
                self.save(i)
        return last_metrics

    def _chunk_runner(self, d: int, sh_deg: int) -> "_ChunkRunner":
        """The runner of (downscale, SH degree) at the current capacity; a
        new phase drops the previous phase's runner and its graphs."""
        key = (d, sh_deg)
        runner = self._runners.get(key)
        if runner is None:
            self._runners = {key: _ChunkRunner(self, self._device_dataset(d), sh_deg, self.config.scan_chunk)}
            runner = self._runners[key]
        return runner

    def train(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        """Run `num_steps` steps (default max_num_iterations) from the
        state's step; returns the last logged metrics."""
        cfg = self.config
        self._maybe_start_viewer()
        n = num_steps if num_steps is not None else cfg.max_num_iterations
        try:
            if cfg.scan_chunk > 1:
                return self._train_scan(n)
            return self._train_steps(n)
        finally:
            profiling.set_chunk(None)

    def _train_steps(self, n: int) -> Dict[str, float]:
        """`n` steps of the per-step loop (`scan_chunk` 0 or 1)."""
        cfg = self.config
        last_metrics: Dict[str, float] = {}
        start = int(self.state.step)
        win_t = time.time()  # steps/s over the steps since the last log or eval
        win_step = start
        for i in range(start, start + n):
            profiling.set_chunk(i)
            with profile_section("step.dispatch", step=i):
                idx, camera, batch = self.datamanager.next_train_indexed(i)
                self.state, metrics = self._dispatch_step(i, idx, camera, batch)
            if i % cfg.steps_per_log == 0:
                self._maybe_grow_isect_capacity(metrics)
                last_metrics = {k: float(v) for k, v in metrics.items() if k != "refine"}
                profiling.flush_marks()  # the step's values came to the host
                last_metrics["step"] = i
                poisoned = not np.isfinite(last_metrics.get("loss", 0.0)) or not last_metrics.get("params_finite", 1.0)
                if cfg.halt_on_nan and poisoned:
                    self._log_metrics(last_metrics, i)
                    raise FloatingPointError(
                        f"non-finite loss or params at step {i} (metrics: {last_metrics}); training halted: a "
                        "poisoned state cannot recover. Resume from the last checkpoint; set halt_on_nan=False "
                        "to continue anyway."
                    )
                now = time.time()
                last_metrics["steps_per_sec"] = (i + 1 - win_step) / max(now - win_t, 1e-9)
                win_t, win_step = now, i + 1
                self._log_metrics(last_metrics, i)
            if cfg.steps_per_eval_all_images and (i + 1) % cfg.steps_per_eval_all_images == 0:
                ev = self.eval_all(
                    max_images=cfg.eval_all_max_images,
                    dump_dir=Path(cfg.eval_dump_dir) / f"step_{i + 1:09d}" if cfg.eval_dump_dir else None,
                )
                ev["step"] = i + 1
                ev["eval"] = "all"
                self._log_metrics(ev, i + 1, "eval")
                win_t, win_step = time.time(), i + 1  # eval time is not billed to steps/s
            elif cfg.steps_per_eval_image and (i + 1) % cfg.steps_per_eval_image == 0:
                ev = self.eval_one(i + 1)
                if ev is not None:
                    self._log_metrics(ev, i + 1, "eval_image")
                win_t, win_step = time.time(), i + 1
            if cfg.steps_per_save and (i + 1) % cfg.steps_per_save == 0:
                self.save(i + 1)
        return last_metrics

    # ------------------------------------------------------------------
    def eval_one(self, step: int) -> Optional[Dict[str, float]]:
        """Single-image eval (the reference's steps_per_eval_image cadence)."""
        dm = self.eval_datamanager or self.datamanager
        if len(dm) == 0:
            return None
        with profile_section("eval.one", step=step):
            idx = step % len(dm)
            camera, batch = dm.get_batch(idx)
            rgb = self._render_rgb(camera)
            gt = batch["image"][..., :3]
            return {
                "step": step, "eval": "image", "eval_idx": idx, "psnr": float(psnr(rgb, gt)),
                "ssim": float(ssim(rgb, gt)),
            }

    def _eval_arena(self, dm: FullImageDatamanager, max_images: Optional[int]) -> Optional[DeviceArena]:
        """The eval split's first `max_images` frames stacked on the device
        (camera fields and `image[..., :3]`), or None for an empty split or
        one of mixed sizes, which `eval_all` loops over frame by frame. Keyed
        on the datamanager object, which the cache holds: a new datamanager
        that reused a collected one's id would otherwise get its frames."""
        key = (dm, max_images)
        cached = self._eval_arena_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        cams, gts = [], []
        for camera, batch in dm.eval_frames():
            cams.append(camera)
            gts.append({"image": batch["image"][..., :3]})
            if max_images and len(cams) >= max_images:
                break
        arena = None
        if cams and len({(c.height, c.width) for c in cams}) == 1:
            arena = DeviceArena.stack(cams, None, gts)
        self._eval_arena_cache = (key, arena)
        return arena

    def _eval_sweep(self, arena: DeviceArena) -> "_EvalSweep":
        """The sweep of `arena` at the current state, rebuilt when anything
        its render captures changes: the `_eval_scan_key` objects, the state
        object, the arena (its frames, their count and size), the SH degree, and the
        warm-up gate, which a graph captured before warm-up must not replay
        after. The sweep holds every object whose id is in its key."""
        splat = self.config.splat
        key = self._eval_scan_key() + (id(self.state), id(arena), splat.sh_degree, self.state.step >= splat.warm_up)
        cached = self._eval_sweep_cache
        if cached is None or cached[0] != key:
            self._eval_sweep_cache = cached = (key, _EvalSweep(self, arena, self._eval_scan_render()))
        return cached[1]

    def eval_all(self, max_images: Optional[int] = None, dump_dir: Optional[Path] = None) -> Dict[str, float]:
        """PSNR / SSIM / LPIPS and rays per second over the eval split (ref
        eval loop, freegaussian_pipeline.py:103-172). LPIPS runs on the
        device when its local weights file exists (`models/metrics.py`);
        without it the report carries NaN with lpips_available False, as the
        JAX package's does. `dump_dir` writes gt|pred side-by-side PNGs per
        image (ref :144-147).

        Without LPIPS and dumps, an eval split of one frame size is swept on
        the device (`_EvalSweep`) with one host copy, as the JAX package's
        one-dispatch sweep; LPIPS and the dumps need each frame on the host,
        so they keep the per-frame loop, as do empty and mixed-size splits."""
        with profile_section("eval.all", max_images=max_images):
            return self._eval_all(max_images, dump_dir)

    def _eval_all(self, max_images: Optional[int], dump_dir: Optional[Path]) -> Dict[str, float]:
        from ..models.metrics import lpips, lpips_available
        from ..viewer.png import encode_png

        dm = self.eval_datamanager or self.datamanager
        if dump_dir is None and not lpips_available(self.device):
            arena = self._eval_arena(dm, max_images)
            if arena is not None:
                t0 = time.time()
                table = self._eval_sweep(arena).run()
                wall = max(time.time() - t0, 1e-9)
                n = table.shape[0]
                return {
                    "psnr": float(np.mean(table[:, 0])),
                    "ssim": float(np.mean(table[:, 1])),
                    "num_rays_per_sec": n * arena.width * arena.height / wall,
                    "fps": n / wall,
                    "gaussian_count": int(self.state.alive.sum()),
                    "lpips": float("nan"),
                    "lpips_available": False,
                }
        if dump_dir is not None:
            Path(dump_dir).mkdir(parents=True, exist_ok=True)
        psnrs, ssims, lpipss = [], [], []
        t0 = time.time()
        n_pix = count = 0
        for camera, batch in dm.eval_frames():
            rgb = self._render_rgb(camera)
            gt = batch["image"][..., :3]
            psnrs.append(float(psnr(rgb, gt)))
            ssims.append(float(ssim(rgb, gt)))
            lp = lpips(rgb, gt)
            if lp is not None:
                lpipss.append(lp)
            if dump_dir is not None:
                pair = torch.cat([gt, rgb], dim=1).clamp(0, 1).cpu().numpy()
                (Path(dump_dir) / f"eval_{count:04d}.png").write_bytes(encode_png((pair * 255).astype(np.uint8)))
            n_pix += camera.width * camera.height
            count += 1
            if max_images and count >= max_images:
                break
        wall = max(time.time() - t0, 1e-9)
        return {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            "num_rays_per_sec": n_pix / wall,
            "fps": count / wall,
            "gaussian_count": int(self.state.alive.sum()),
            "lpips": float(np.mean(lpipss)) if lpipss else float("nan"),
            "lpips_available": bool(lpipss),
        }

    # ------------------------------------------------------------------
    def save(self, step: int) -> Path:
        path = self.out_dir / "checkpoints"
        with profile_section("save", step=step):
            save_checkpoint(path, step, self.state)
        return path

    def load(self, path: Path, step: Optional[int] = None) -> None:
        self.state = load_checkpoint(Path(path), self.state, step)
        # the loaded state's tensors are new: graphs of the old ones are stale
        self._runners = {}
        self._eval_sweep_cache = None


_LAUNCH_TABLES = {
    name: table for table in (rasterize_cuda.LAUNCHES, mlp_cuda.LAUNCHES, adam_cuda.LAUNCHES) for name in table
}


def _warm_up(dev: torch.device, body) -> None:
    """`body` run eagerly on a side stream, as a capture's warm-up must."""
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)


def _capture(body, generator: Optional[torch.Generator] = None, pool=None):
    """`body` captured as a CUDA graph (in `pool`; `generator` registered so
    that a replay draws what the eager body would). The capture launches no
    kernel, so the launch counters are set back after it. Returns (graph,
    capture seconds, each kernel's launches a replay, the graph's kernel
    nodes)."""
    before = {name: table[name] for name, table in _LAUNCH_TABLES.items()}
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if generator is not None:
        graph.register_generator_state(generator)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool):
        body()
    nodes = _kernel_nodes(graph.raw_cuda_graph())
    graph.instantiate()
    seconds = time.perf_counter() - t0
    captured = {}
    for name, table in _LAUNCH_TABLES.items():
        if table[name] != before[name]:
            captured[name] = table[name] - before[name]
            table[name] = before[name]
    return graph, seconds, captured, nodes


def _kernel_nodes(raw_graph: int) -> int:
    """The kernel nodes of a captured CUDA graph (a `cudaGraph_t`, which is
    libcuda's `CUgraph`), counted through libcuda's graph calls."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    get_nodes, get_type = cuda.cuGraphGetNodes, cuda.cuGraphNodeGetType
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
    get_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    get_nodes.restype = get_type.restype = ctypes.c_int  # CUresult
    n = ctypes.c_size_t(0)
    if get_nodes(raw_graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if get_nodes(raw_graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        if get_type(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


class _ChunkRunner:
    """Runs a chunk's steps for one (downscale phase, SH degree) from device
    tables: the frame index of each step (`idx`), each group's Adam scalars
    (`scalars`, `optimizers.adam_scalars` at the group's count, one row a
    step) and a step cursor; each step writes its metrics into its row of
    `metrics`, which come to the host once per chunk.

    On the card each step variant (`Trainer._step_variant`) is captured
    once as a CUDA graph: its first step runs eagerly on a side stream (the
    warm-up, which also builds the kernels and sizes the metrics table),
    then the same step is captured, and its later steps replay the graph.
    The graph reads the cursor, the tables and the state's tensors, all at
    fixed addresses, and advances the cursor itself, so a chunk launches its
    replays back to back with no host synchronisation. The state's generator
    is registered with each graph, so a replay draws the random background
    the eager step would. The host keeps the step and the Adam counts: a
    replay adds the counts the captured step added. The capture launches no
    kernel, so the launch counters are set back after it, and
    `trainer.graph_stats["replayed_launches"]` adds each graph's captured
    launches at every replay. Refinement runs eagerly after its step (it
    reads counts on the host) and rewrites the step's state metrics. A
    capture or replay error raises: there is no eager fallback. On the CPU
    every step runs eagerly through the same tables.

    Each step marks its phases (`utils/profiling.py:mark`); a graph holds
    its marks as event nodes, so its capture does not depend on whether
    anything is recorded. While recording, each chunk adds the last
    replay's phase times of every graph it replayed, weighted by its
    replays, the graphs' replays and kernel nodes, the field kernels'
    live-block fill at its end, and each refinement's counts (kept on the
    device) and device time (between two pooled events), all read after
    the chunk's one copy of its metrics to the host."""

    def __init__(self, trainer: Trainer, arena: DeviceArena, sh_deg: int, length: int):
        self.trainer = trainer
        self.arena = arena
        self.sh_deg = sh_deg
        dev = trainer.device
        self.groups = sorted(trainer.state.opt_states)
        self.idx = torch.zeros(length, dtype=torch.long, device=dev)
        self.scalars = torch.zeros((length, len(self.groups), 3), device=dev)
        self.cursor = torch.zeros(1, dtype=torch.long, device=dev)
        self.keys: Optional[List[str]] = None
        self.metrics: Optional[torch.Tensor] = None
        self.graphs: Dict[tuple, tuple] = {}
        self.pool = None
        # the field kernels' live blocks at a chunk's end, copied to the host
        # with the chunk's metrics while recording
        self.block_count = torch.zeros(1, dtype=torch.int32, pin_memory=dev.type == "cuda")

    def _body(self, variant: tuple) -> None:
        """One step from the tables' row at the cursor; advances the cursor."""
        t = self.trainer
        k = self.cursor
        profiling.mark("forward", k.device)
        frame = self.idx.index_select(0, k)
        camera, camera0, batch = self.arena.select(frame)
        row = self.scalars.index_select(0, k)[0]
        metrics = t._step_core(
            camera, camera0, batch, self.sh_deg, frame, variant, {g: row[j] for j, g in enumerate(self.groups)}
        )
        with torch.no_grad():
            metrics.update(state_metrics(t.state, t._metric_groups()))
            if self.keys is None:
                self.keys = list(metrics)
                self.metrics = torch.zeros((self.idx.shape[0], len(self.keys)), device=k.device)
            self.metrics.index_copy_(0, k, torch.stack([metrics[n].float().reshape(()) for n in self.keys])[None])
            self.cursor.add_(1)
        profiling.mark(profiling.END, k.device)

    def _graphed(self, variant: tuple, step: int, first: bool) -> bool:
        """The step of `variant` on the card: a replay of its graph, or its
        warm-up and capture. Returns whether it replayed."""
        t, st = self.trainer, self.trainer.state
        entry = self.graphs.get(variant)
        if entry is not None:
            graph, count_delta, launches, _ = entry
            with profile_section("chunk.step", step=step, variant=variant, first=first):
                graph.replay()
                for g, dc in count_delta.items():
                    st.opt_states[g].count += dc
                stats = t.graph_stats
                stats["replays"] += 1
                for name, c in launches.items():
                    stats["replayed_launches"][name] = stats["replayed_launches"].get(name, 0) + c
            return True
        with profile_section("chunk.capture", step=step, variant=variant, first=first):
            _warm_up(t.device, lambda: self._body(variant))  # the warm-up is this step, run eagerly
            counts = {g: s.count for g, s in st.opt_states.items()}
            marks: list = []

            def body():
                with profiling.capture_marks(marks):
                    self._body(variant)

            graph, seconds, captured, nodes = _capture(body, st.generator, self.pool)
            t.graph_stats["capture_s"] += seconds
            t.graph_stats["captures"] += 1
            t.graph_stats["kernel_nodes"][variant] = nodes
            count_delta = {g: s.count - counts[g] for g, s in st.opt_states.items() if s.count != counts[g]}
            for g in count_delta:
                st.opt_states[g].count = counts[g]
            self.pool = graph.pool()
            self.graphs[variant] = (graph, count_delta, captured, marks)
        return False

    def run(self, start: int, frames: List[int]) -> Dict[str, np.ndarray]:
        """Steps start .. start + len(frames) - 1 on `frames`; returns each
        metric's values, one a step."""
        t, st = self.trainer, self.trainer.state
        n = len(frames)
        with profile_section("chunk.prepare", steps=n):
            self.idx[:n].copy_(torch.tensor(frames, dtype=torch.long))
            table = [[adam_scalars(t.optimizers[g], st.opt_states[g].count + j) for g in self.groups] for j in range(n)]
            self.scalars[:n].copy_(torch.tensor(table, dtype=torch.float32))
            self.cursor.zero_()
        recording = profiling.enabled()
        replays: Dict[tuple, int] = {}
        refines: List[tuple] = []  # while recording: (step, its counts on the device, start, end stamp)
        for j in range(n):
            s = start + j
            variant = t._step_variant(s)
            if t.device.type != "cuda":
                with profile_section("chunk.step", step=s, variant=variant, first=j == 0):
                    self._body(variant)
            elif self._graphed(variant, s, j == 0):
                replays[variant] = replays.get(variant, 0) + 1
            st.step += 1
            before = profiling.stamp(t.device) if recording else None
            refined = t._refine_at(s, (self.arena.height, self.arena.width))
            if refined is not None:
                with torch.no_grad():
                    for name, v in state_metrics(st, t._metric_groups()).items():
                        self.metrics[j, self.keys.index(name)] = v.float()
                if recording:
                    counts = torch.stack([refined[f"num_{k}"].reshape(()).long() for k in REFINE_COUNTS])
                    refines.append((s, counts, before, profiling.stamp(t.device)))
            elif recording:
                profiling.release(before)
        with profile_section("chunk.collect", steps=n):
            if recording:  # the block list's live-block count, as the kernels take it
                self.block_count.copy_(mlp_cuda.live_blocks(st.alive)[-1:], non_blocking=True)
                if refines:
                    refine_counts = torch.stack([c for _, c, _, _ in refines]).to("cpu", non_blocking=True)
            out = self.metrics[:n].cpu().numpy()
            if recording:
                self._record(replays, int(out[-1, self.keys.index("gaussian_count")]))
                for (s, _, a, b), row in zip(refines, refine_counts.tolist() if refines else ()):
                    _record_refine(s, row, profiling.elapsed_ms(a, b))
        return {name: out[:, c] for c, name in enumerate(self.keys)}

    def _record(self, replays: Dict[tuple, int], live: int) -> None:
        """The chunk's counters, once its metrics are on the host: each
        replayed graph's phases (its last replay's, weighted by its
        replays), replays and kernel nodes, the eager steps' phases, and the
        field kernels' `live` rows and the rows of the 128-row blocks that
        hold them (`mlp_cuda.live_blocks`)."""
        profiling.flush_marks()
        cap = self.trainer._isect_capacity()
        for variant, count in replays.items():
            profiling.add_graph_phases(self.graphs[variant][3], count)
            label = str((self.arena.width, self.arena.height, self.sh_deg, cap) + variant)
            profiling.add("step.replays", count, key=label)
            profiling.put("step.kernel_nodes", self.trainer.graph_stats["kernel_nodes"][variant], key=label)
        profiling.add("field.live_rows", live)
        profiling.add("field.block_rows", int(self.block_count[0]) * mlp_cuda.ROWS)


# the counts of a refinement that the chunk runner records (`refine_at`'s num_<name>)
REFINE_COUNTS = ("split", "dup", "culled", "alive", "dropped")


def _record_refine(step: int, counts: List[int], device_ms: float) -> None:
    """One refinement's counters, by its step: its counts and the device ms
    between the stamps around it (the chunk's replays before it excluded)."""
    profiling.add("refine.count", 1)
    for name, value in zip(REFINE_COUNTS, counts):
        profiling.put(f"refine.{name}", value, key=str(step))
    profiling.put("refine.device_ms", device_ms, key=str(step))


class _EvalSweep:
    """PSNR and SSIM of every frame of an eval arena at the trainer's state
    (the JAX package's `_eval_sweep_fn`, a `lax.scan` over the frames in one
    dispatch). A frame reads its index at a device cursor, selects its
    camera and ground truth from the arena, renders (`render`, the
    trainer's `_eval_scan_render`), writes (psnr, ssim) into its row of an
    (F, 2) device table and advances the cursor; the table comes to the host
    once a sweep.

    On the card the frame is captured once as a CUDA graph, as
    `_ChunkRunner` captures a step: the first sweep's first frame runs
    eagerly on a side stream (the warm-up, which also builds the kernels),
    then the frame is captured, and every later frame replays the graph,
    back to back with no host synchronisation. The eval render draws no
    random numbers, so no generator is registered. The capture launches no
    kernel, so the launch counters are set back after it, and each replay
    adds the graph's captured launches to them. The graph keeps its own
    memory pool. A capture or replay error raises: there is no eager
    fallback. On the CPU every frame runs eagerly."""

    def __init__(self, trainer: Trainer, arena: DeviceArena, render):
        self.trainer = trainer
        self.state = trainer.state
        self.arena = arena
        self.render = render
        dev = trainer.device
        self.cursor = torch.zeros(1, dtype=torch.long, device=dev)
        self.table = torch.zeros((arena.cameras["c2w"].shape[0], 2), device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}  # each kernel's launches a replay

    @torch.no_grad()
    def _frame(self) -> None:
        k = self.cursor
        camera, _, batch = self.arena.select(k)
        rgb = self.render(self.state, camera)
        gt = batch["image"]
        self.table.index_copy_(0, k, torch.stack([psnr(rgb, gt), ssim(rgb, gt)])[None])
        self.cursor.add_(1)

    def _capture(self) -> None:
        """The warm-up frame, then the frame's graph."""
        with profile_section("eval.capture"):
            _warm_up(self.trainer.device, self._frame)
            self.graph, seconds, self.launches, _ = _capture(self._frame)
        stats = self.trainer.eval_graph_stats
        stats["capture_s"] += seconds
        stats["captures"] += 1

    def run(self) -> np.ndarray:
        """(F, 2) float64: each frame's (psnr, ssim)."""
        n = self.table.shape[0]
        self.cursor.zero_()
        if self.trainer.device.type != "cuda":
            for _ in range(n):
                self._frame()
        else:
            replays = n
            if self.graph is None:
                self._capture()
                replays -= 1
            for _ in range(replays):
                self.graph.replay()
                for name, count in self.launches.items():
                    _LAUNCH_TABLES[name][name] += count
            self.trainer.eval_graph_stats["replays"] += replays
        return self.table.cpu().numpy().astype(np.float64)
