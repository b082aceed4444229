"""Trainer (twin of `freegaussian_tpu/engine/trainer.py`): the training-loop
shell of the `train` verb. It owns setup (dataparser -> datamanager ->
Gaussians -> fields -> optimizers -> state), the step loop with the
reference's schedules (progressive downscale phases, the SH-degree schedule,
eval / save / log cadences), checkpoints and metric logging
(`metrics.jsonl`: psnr, loss, gaussian_count, steps_per_sec, the fields the
reference instruments, freegaussian_pipeline.py:128-156).

PyTorch runs eagerly: the step (`engine/train_step.py`) updates the state in
place. Left out, as TPU machinery: the intersection-capacity self-tuner (the
port's binning is exact-size), the `scan_chunk` dispatch with its device
dataset, and the stacked eval arena (eval renders frame by frame).
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.cameras import Camera
from ..data.datamanager import FullImageDatamanager
from ..data.dataparsers import PARSERS, ParsedDataset
from ..models.densify import DensifyConfig
from ..models.gaussians import init_gaussians
from ..models.splat_model import SplatConfig, forward, make_control_field, make_deform_field, psnr, sh_degree_to_use
from ..models.ssim import ssim
from ..ops.math import resize_image
from .checkpoints import load_checkpoint, save_checkpoint
from .optimizers import OptimizersConfig, make_optimizers
from .train_step import create_train_state, make_train_step


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
        deform = make_deform_field(config.splat).reset_parameters(init_gen, config.splat.deform_head_init_scale)
        self.control = make_control_field(config.splat).reset_parameters(init_gen).to(dev)
        self.optimizers = make_optimizers(config.optimizers)
        self.state = create_train_state(params, alive, deform.to(dev), self.optimizers, generator=self.generator)
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
        """The stage-1 step; ControlTrainer builds its stage-2 step."""
        self.step_fn = make_train_step(
            self.config.splat, self.config.densify, self.optimizers, num_train_data=len(self.datamanager)
        )

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

    def start_viewer(self, port: int = 7007, width: int = 480, height: int = 360):
        """Background HTTP viewer over the live model; returns the server."""
        from ..viewer.server import ViewerServer

        server = ViewerServer(
            self.viewer_render_fn(), num_attributes=self.viewer_num_attributes(),
            width=width, height=height, port=port, device=self.device,
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
            h, w = camera.height, camera.width
            dev = self.device
            if "flow" not in batch:
                batch["flow"] = torch.zeros((h, w, 2), device=dev)
                batch["flow_valid"] = torch.tensor(0.0, device=dev)
            else:
                batch["flow_valid"] = torch.tensor(1.0, device=dev)
            if cfg.splat.flow_3d_loss_weight > 0:
                if "depth0" not in batch:
                    batch["depth0"] = torch.zeros((h, w, 1), device=dev)
                    batch["depth0_valid"] = torch.tensor(0.0, device=dev)
                else:
                    batch["depth0_valid"] = torch.tensor(1.0, device=dev)
        return self.step_fn(self.state, camera, batch, sh_degree_to_use(cfg.splat, i), camera0=camera0)

    def _maybe_start_viewer(self) -> None:
        if "viewer" in self.config.vis and self._viewer is None:
            self._viewer = self.start_viewer(port=self.config.viewer_port)

    def train(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        """Run `num_steps` steps (default max_num_iterations) from the
        state's step; returns the last logged metrics."""
        cfg = self.config
        self._maybe_start_viewer()
        n = num_steps if num_steps is not None else cfg.max_num_iterations
        last_metrics: Dict[str, float] = {}
        start = int(self.state.step)
        win_t = time.time()  # steps/s over the steps since the last log or eval
        win_step = start
        for i in range(start, start + n):
            idx, camera, batch = self.datamanager.next_train_indexed(i)
            self.state, metrics = self._dispatch_step(i, idx, camera, batch)
            if i % cfg.steps_per_log == 0:
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
        """PSNR / SSIM and rays per second over the eval split (ref eval loop,
        freegaussian_pipeline.py:103-172). LPIPS needs pretrained weights the
        port has no network for: it reports NaN with lpips_available False,
        as the JAX package does without its local weights file. `dump_dir`
        writes gt|pred side-by-side PNGs per image (ref :144-147)."""
        from ..viewer.png import encode_png

        dm = self.eval_datamanager or self.datamanager
        if dump_dir is not None:
            Path(dump_dir).mkdir(parents=True, exist_ok=True)
        psnrs, ssims = [], []
        t0 = time.time()
        n_pix = count = 0
        for camera, batch in dm.eval_frames():
            rgb = self._render_rgb(camera)
            gt = batch["image"][..., :3]
            psnrs.append(float(psnr(rgb, gt)))
            ssims.append(float(ssim(rgb, gt)))
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
            "lpips": float("nan"),
            "lpips_available": False,
        }

    # ------------------------------------------------------------------
    def save(self, step: int) -> Path:
        path = self.out_dir / "checkpoints"
        save_checkpoint(path, step, self.state)
        return path

    def load(self, path: Path, step: Optional[int] = None) -> None:
        self.state = load_checkpoint(Path(path), self.state, step)
