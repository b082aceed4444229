"""Command-line entry of the port: the `train`, `train-control` and `viewer` verbs.

    python -m freegaussian_tpu_torch.cli train --data <dir> --config configs/sim/base.yaml \
        [--scene-config scene.yaml] [--dataparser synthetic|dnerf] [--load <checkpoint dir>] \
        [--max-iterations N] [--capacity N] [--deform-impl fused|pallas|headsfused] [--device cuda|cpu]
    python -m freegaussian_tpu_torch.cli train-control --data <dir> --config configs/control/sim/base.yaml \
        --stage1-checkpoint <checkpoint dir or reference .ckpt> [--gaussian-mask gaussian_mask_NxM.npy] ...
    python -m freegaussian_tpu_torch.cli viewer --checkpoint step-000030000.ckpt \
        [--gaussian-mask gaussian_mask_NxM.npy] [--deform-impl fused|pallas|headsfused] \
        [--width 480] [--height 360] [--port 7007] [--host 0.0.0.0] [--device cuda]

`train` and `train-control` take the JAX package's flags (config overlay,
dataset, checkpoint to resume from, step count, padded capacity) and write
`<output_dir>/<experiment_name>/metrics.jsonl` and step checkpoints; the last
line of their standard output is the last logged metrics as JSON.
`--deform-impl` sets `SplatConfig.deform_impl` where the config does not set
`pipeline.model.deform_impl` ("pallas" runs the deform and control trunks on
the field-trunk kernels). `--device` defaults to cuda and exits non-zero
without a GPU; `--device cpu` runs the kernels' plain versions.

`viewer` serves a reference-format checkpoint (what the JAX package writes
with `export --format torch`) through the HTTP viewer: a stage-1
checkpoint, or with `--gaussian-mask` a stage-2 checkpoint (one with
`control.*` keys) and its cluster mask, whose attribute sliders drive the
control field. The other dataset-bound verbs (eval, render, cluster, ...)
come with later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

from .models.splat_model import SplatConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="freegaussian-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def train_flags(sp):
        sp.add_argument("--data", default="")
        sp.add_argument("--dataparser", default="")
        sp.add_argument("--config", default="")
        sp.add_argument("--scene-config", default="")
        sp.add_argument("--load", default="", help="resume from this checkpoint directory (its latest step)")
        sp.add_argument("--max-iterations", type=int, default=0)
        sp.add_argument("--capacity", type=int, default=0)
        sp.add_argument("--deform-impl", default=None,
                        help="SplatConfig.deform_impl where the config does not set pipeline.model.deform_impl")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    sp = sub.add_parser("train", help="stage-1 training")
    train_flags(sp)
    sp = sub.add_parser("train-control", help="stage-2 control training")
    train_flags(sp)
    sp.add_argument("--stage1-checkpoint", required=True,
                    help="a stage-1 checkpoint directory of this port, or a reference .ckpt")
    sp.add_argument("--gaussian-mask", default="")
    sp = sub.add_parser("viewer", help="serve the interactive orbit viewer over a reference checkpoint")
    sp.add_argument("--checkpoint", required=True, help="reference-format .ckpt")
    sp.add_argument("--gaussian-mask", default=None,
                    help="gaussian_mask_NxM.npy: serve stage 2 (the checkpoint must carry control.* keys)")
    sp.add_argument("--deform-impl", default=SplatConfig.deform_impl,
                    help="SplatConfig.deform_impl: fused (default), pallas, or headsfused (split-linear chains)")
    sp.add_argument("--port", type=int, default=7007)
    sp.add_argument("--host", default="0.0.0.0", help="address to bind (127.0.0.1: this machine only)")
    sp.add_argument("--width", type=int, default=480)
    sp.add_argument("--height", type=int, default=360)
    sp.add_argument("--device", default="cuda")
    return p


def start_viewer(
    checkpoint: Path, *, port: int, width: int, height: int, device: str, host: str = "0.0.0.0",
    gaussian_mask: Optional[Path] = None, deform_impl: str = SplatConfig.deform_impl,
):
    """Load the checkpoint (with `gaussian_mask`, as a stage-2 model) and
    start the viewer in the background; returns (model, server)."""
    from .models.torch_compat import load_control_checkpoint, load_reference_checkpoint
    from .viewer.server import ViewerServer, control_render_fn, model_render_fn

    cfg = SplatConfig(deform_impl=deform_impl)
    if gaussian_mask is None:
        model = load_reference_checkpoint(checkpoint, cfg=cfg, device=device)
        render_fn, num_attributes = model_render_fn(model), 0
    else:
        model = load_control_checkpoint(checkpoint, gaussian_mask, cfg=cfg, device=device)
        render_fn, num_attributes = control_render_fn(model), model.num_attributes
    server = ViewerServer(
        render_fn, num_attributes=num_attributes, width=width, height=height, port=port, host=host, device=device
    )
    server.start_background()
    print(f"viewer: http://localhost:{server.port}/")
    return model, server


def trainer_config(args):
    """The TrainerConfig of a train verb: the YAML overlay, then the flags."""
    from .engine.config import load_yaml_overlay, trainer_config_from_yaml
    from .engine.trainer import TrainerConfig

    cfg = trainer_config_from_yaml(args.config, args.scene_config or None) if args.config else TrainerConfig()
    if args.deform_impl:
        tree = load_yaml_overlay(args.config, args.scene_config or None) if args.config else {}
        if "deform_impl" not in (tree.get("pipeline") or {}).get("model", {}) and "deform_impl" not in tree.get("model", {}):
            cfg = dataclasses.replace(cfg, splat=dataclasses.replace(cfg.splat, deform_impl=args.deform_impl))
    if args.data:
        cfg = dataclasses.replace(cfg, data=args.data)
    if args.dataparser:
        cfg = dataclasses.replace(cfg, dataparser=args.dataparser)
    if args.max_iterations:
        cfg = dataclasses.replace(cfg, max_num_iterations=args.max_iterations)
    if args.capacity:
        cfg = dataclasses.replace(cfg, capacity=args.capacity)
    return cfg


def _train(args):
    """Build the verb's trainer, train, save the last step; returns the last
    logged metrics."""
    from .device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"freegaussian-tpu-torch {args.cmd}: {e}") from None
    cfg = trainer_config(args)
    if args.cmd == "train":
        from .engine.trainer import Trainer

        trainer = Trainer(cfg, device=device)
    else:
        from .engine.control_trainer import ControlTrainer

        trainer = ControlTrainer(
            cfg, load_deformable_checkpoint=Path(args.stage1_checkpoint),
            gaussian_mask_path=Path(args.gaussian_mask) if args.gaussian_mask else None, device=device,
        )
    if args.load:
        trainer.load(Path(args.load))
    metrics = trainer.train()
    trainer.save(int(trainer.state.step))
    return trainer, metrics


def main(argv=None):
    """Run a verb; the train verbs return their trainer (for callers in
    process, such as chip_smoke.py)."""
    args = build_parser().parse_args(argv)
    if args.cmd in ("train", "train-control"):
        trainer, metrics = _train(args)
        print(json.dumps(metrics))
        return trainer
    elif args.cmd == "viewer":
        _, server = start_viewer(
            Path(args.checkpoint), port=args.port, width=args.width, height=args.height,
            device=args.device, host=args.host,
            gaussian_mask=Path(args.gaussian_mask) if args.gaussian_mask else None, deform_impl=args.deform_impl,
        )
        print("serving; ctrl-c to stop")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.shutdown()


if __name__ == "__main__":
    main()
