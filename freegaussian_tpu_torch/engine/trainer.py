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
CPU the same steps run eagerly. Left out: the stacked eval arena (eval
renders frame by frame).
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
from ..ops import mlp_cuda, rasterize_cuda
from ..ops.math import resize_image
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
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0, "replayed_launches": {}}
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
        st = self.state
        return forward(
            self.config.splat, st.params, st.alive, camera,
            deform=st.deform, sh_degree_now=self.config.splat.sh_degree,
            warmed_up=st.step >= self.config.splat.warm_up, train=False,
        )["rgb"]

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
            self._rebuild_step_fn()

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
        if cfg.scan_chunk > 1:
            return self._train_scan(n)
        last_metrics: Dict[str, float] = {}
        start = int(self.state.step)
        win_t = time.time()  # steps/s over the steps since the last log or eval
        win_step = start
        for i in range(start, start + n):
            idx, camera, batch = self.datamanager.next_train_indexed(i)
            self.state, metrics = self._dispatch_step(i, idx, camera, batch)
            if i % cfg.steps_per_log == 0:
                self._maybe_grow_isect_capacity(metrics)
                last_metrics = {k: float(v) for k, v in metrics.items() if k != "refine"}
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
        idx = step % len(dm)
        camera, batch = dm.get_batch(idx)
        rgb = self._render_rgb(camera)
        gt = batch["image"][..., :3]
        return {"step": step, "eval": "image", "eval_idx": idx, "psnr": float(psnr(rgb, gt)), "ssim": float(ssim(rgb, gt))}

    def eval_all(self, max_images: Optional[int] = None, dump_dir: Optional[Path] = None) -> Dict[str, float]:
        """PSNR / SSIM / LPIPS and rays per second over the eval split (ref
        eval loop, freegaussian_pipeline.py:103-172). LPIPS runs on the
        device when its local weights file exists (`models/metrics.py`);
        without it the report carries NaN with lpips_available False, as the
        JAX package's does. `dump_dir` writes gt|pred side-by-side PNGs per
        image (ref :144-147)."""
        from ..models.metrics import lpips
        from ..viewer.png import encode_png

        dm = self.eval_datamanager or self.datamanager
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
        save_checkpoint(path, step, self.state)
        return path

    def load(self, path: Path, step: Optional[int] = None) -> None:
        self.state = load_checkpoint(Path(path), self.state, step)
        self._runners = {}  # the loaded state's tensors are new: graphs of the old ones are stale


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
    every step runs eagerly through the same tables."""

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

    def _body(self, variant: tuple) -> None:
        """One step from the tables' row at the cursor; advances the cursor."""
        t = self.trainer
        k = self.cursor
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

    def _graphed(self, variant: tuple) -> None:
        t, st = self.trainer, self.trainer.state
        entry = self.graphs.get(variant)
        if entry is not None:
            graph, count_delta, launches = entry
            graph.replay()
            for g, dc in count_delta.items():
                st.opt_states[g].count += dc
            stats = t.graph_stats
            stats["replays"] += 1
            for name, c in launches.items():
                stats["replayed_launches"][name] = stats["replayed_launches"].get(name, 0) + c
            return
        dev = t.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body(variant)  # the warm-up is this step, run eagerly
        torch.cuda.current_stream(dev).wait_stream(side)
        counts = {g: s.count for g, s in st.opt_states.items()}
        launches = {**rasterize_cuda.LAUNCHES, **mlp_cuda.LAUNCHES}
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(st.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool):
            self._body(variant)
        t.graph_stats["capture_s"] += time.perf_counter() - t0
        t.graph_stats["captures"] += 1
        count_delta = {g: s.count - counts[g] for g, s in st.opt_states.items() if s.count != counts[g]}
        for g in count_delta:
            st.opt_states[g].count = counts[g]
        captured = {}
        for table in (rasterize_cuda.LAUNCHES, mlp_cuda.LAUNCHES):
            for name in table:
                if table[name] != launches[name]:
                    captured[name] = table[name] - launches[name]
                    table[name] = launches[name]
        self.pool = graph.pool()
        self.graphs[variant] = (graph, count_delta, captured)

    def run(self, start: int, frames: List[int]) -> Dict[str, np.ndarray]:
        """Steps start .. start + len(frames) - 1 on `frames`; returns each
        metric's values, one a step."""
        t, st = self.trainer, self.trainer.state
        n = len(frames)
        self.idx[:n].copy_(torch.tensor(frames, dtype=torch.long))
        table = [[adam_scalars(t.optimizers[g], st.opt_states[g].count + j) for g in self.groups] for j in range(n)]
        self.scalars[:n].copy_(torch.tensor(table, dtype=torch.float32))
        self.cursor.zero_()
        for j in range(n):
            s = start + j
            variant = t._step_variant(s)
            if t.device.type == "cuda":
                self._graphed(variant)
            else:
                self._body(variant)
            st.step += 1
            if t._refine_at(s, (self.arena.height, self.arena.width)) is not None:
                with torch.no_grad():
                    for name, v in state_metrics(st, t._metric_groups()).items():
                        self.metrics[j, self.keys.index(name)] = v.float()
        out = self.metrics[:n].cpu().numpy()
        return {name: out[:, c] for c, name in enumerate(self.keys)}
