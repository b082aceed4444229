"""Command-line entry of the port: the `interflow`, `train`, `train-control`,
`cluster`, `eval`, `render`, `export` and `viewer` verbs, the whole two-stage
pipeline from a capture on disk.

    python -m freegaussian_tpu_torch.cli interflow --data <dir> [--interval 2] \
        [--form velocity|backproject] [--dataparser synthetic|real] [--flow-dir opticalflow] [--device cuda|cpu]
    python -m freegaussian_tpu_torch.cli train --data <dir> --config configs/sim/base.yaml \
        [--scene-config scene.yaml] [--dataparser synthetic|dnerf|real|conerf] [--load <checkpoint dir>] \
        [--max-iterations N] [--capacity N] [--deform-impl fused|pallas|headsfused] [--device cuda|cpu]
    python -m freegaussian_tpu_torch.cli cluster --data <dir> --config configs/sim/base.yaml \
        --load <checkpoint dir> [--key-frames key_frames.yaml --scene <name>] [--dynamic] [--exclusive] \
        [--depth-window LOW HIGH] [--out gaussian_mask_NxM.npy] ...
    python -m freegaussian_tpu_torch.cli train-control --data <dir> --config configs/control/sim/base.yaml \
        --stage1-checkpoint <checkpoint dir or reference .ckpt> [--gaussian-mask gaussian_mask_NxM.npy] ...
    python -m freegaussian_tpu_torch.cli eval --data <dir> --config ... --load <checkpoint dir> \
        [--stage1-checkpoint <dir> --gaussian-mask <mask>] [--dump-images <dir>] [--report <json>] ...
    python -m freegaussian_tpu_torch.cli render --data <dir> --config ... --load <checkpoint dir> \
        [--path dataset|orbit] [--num-frames 60] [--orbit-radius R] [--out renders] ...
    python -m freegaussian_tpu_torch.cli export --data <dir> --config ... --load <checkpoint dir> \
        --out <file> [--format ply|torch] ...
    python -m freegaussian_tpu_torch.cli viewer --data <dir> --config configs/sim/base.yaml \
        --load <checkpoint dir> [--scene-config scene.yaml] [--capacity N] ...
    python -m freegaussian_tpu_torch.cli viewer --data <dir> --config configs/control/sim/base.yaml \
        --stage1-checkpoint <checkpoint dir> [--gaussian-mask gaussian_mask_NxM.npy] [--load <stage-2 dir>] ...
    python -m freegaussian_tpu_torch.cli viewer --checkpoint step-000030000.ckpt \
        [--gaussian-mask gaussian_mask_NxM.npy] [--deform-impl fused|pallas|headsfused] \
        [--width 480] [--height 360] [--port 7007] [--host 0.0.0.0] [--device cuda]

Every verb takes the JAX package's flags (freegaussian_tpu/cli.py) and gives
its outputs. The dataset-bound verbs build a `Trainer` from the dataset and
the config overlay (or, with `--stage1-checkpoint`, a `ControlTrainer`) and
load the port's checkpoint directory `--load` (its latest step).
`--deform-impl` sets `SplatConfig.deform_impl` where the config does not set
`pipeline.model.deform_impl` ("pallas" runs the deform and control trunks on
the field-trunk kernels). `--device` defaults to cuda and exits non-zero
without a GPU; `--device cpu` runs the kernels' plain versions.

- `interflow` turns precomputed optical flow (`opticalflow/{stem}.npy`, or
  `--flow-dir`; zero flow where a frame has none) and the frames' depth
  renders (`depth/{stem}.npy`, from `render`) into the camera-motion-
  compensated flow the flow losses train on: `interflow_n{k}/` for the
  synthetic layout, `flow_n{k}/` for real captures.
- `train` / `train-control` write `<output_dir>/<experiment_name>/metrics.jsonl`
  and step checkpoints; the last line of their standard output is the last
  logged metrics as JSON.
- `cluster` votes the dataset's attribute masks onto the Gaussians over the
  key frames (`--key-frames` and `--scene`, else every frame; `--dynamic`
  deforms the Gaussians to each frame's time) and writes
  `gaussian_mask_<live>x<M>.npy` (default: in `--data`) and its `.ply`.
- `eval` prints (and with `--report` writes) PSNR / SSIM / LPIPS / fps over
  the eval split as JSON, stage 1 or with `--stage1-checkpoint` stage 2;
  `--dump-images` writes gt|pred PNGs.
- `render` writes `<out>/rgb/*.png` and `<out>/depth/*.npy` over the
  dataset's cameras or an orbit.
- `export` writes the live Gaussians as an INRIA PLY or a reference-format
  torch checkpoint (`viewer --checkpoint` serves it).
- `viewer` serves a scene through the HTTP viewer (JPEG frames) by one of
  three routes, exactly one given: stage 1 (`--data`, with `--load`);
  stage 2 (`--stage1-checkpoint` with `--data`, the cluster mask
  `--gaussian-mask`, else the dataset's `gaussian_mask_*.npy`, and a stage-2
  directory `--load`), whose attribute sliders drive the control field; or
  a reference-format checkpoint (`--checkpoint`), stage 1, or with
  `--gaussian-mask` stage 2 (a checkpoint with `control.*` keys).
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

    def data_flags(sp, load_help):
        sp.add_argument("--data", default="")
        sp.add_argument("--dataparser", default="")
        sp.add_argument("--config", default="")
        sp.add_argument("--scene-config", default="")
        sp.add_argument("--load", default="", help=load_help)
        sp.add_argument("--capacity", type=int, default=0)
        sp.add_argument("--deform-impl", default=None,
                        help="SplatConfig.deform_impl where the config does not set pipeline.model.deform_impl")

    def train_flags(sp):
        data_flags(sp, "resume from this checkpoint directory (its latest step)")
        sp.add_argument("--max-iterations", type=int, default=0)
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    sp = sub.add_parser("interflow", help="generate epipolar interflow npys")
    sp.add_argument("--data", required=True)
    sp.add_argument("--interval", type=int, default=2)
    sp.add_argument("--form", choices=["velocity", "backproject"], default="velocity")
    sp.add_argument("--dataparser", choices=["synthetic", "real"], default="synthetic")
    sp.add_argument("--flow-dir", default=None,
                    help="directory of precomputed optical-flow .npy maps (H, W, 2), one per frame stem: the hand-off "
                         "from an external flow network (default opticalflow/; a missing map is zero flow)")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    sp = sub.add_parser("train", help="stage-1 training")
    train_flags(sp)
    sp = sub.add_parser("train-control", help="stage-2 control training")
    train_flags(sp)
    sp.add_argument("--stage1-checkpoint", required=True,
                    help="a stage-1 checkpoint directory of this port, or a reference .ckpt")
    sp.add_argument("--gaussian-mask", default="")

    def dataset_verb(name, help_):
        sp = sub.add_parser(name, help=help_)
        data_flags(sp, "this port's checkpoint directory (its latest step)")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
        return sp

    sp = dataset_verb("cluster", "vote articulation masks onto Gaussians")
    sp.add_argument("--key-frames", default="", help="key_frames.yaml path")
    sp.add_argument("--scene", default="", help="scene name in key_frames.yaml")
    sp.add_argument("--dynamic", action="store_true", help="deform to frame times")
    sp.add_argument("--out", default="", help="default: <data>/gaussian_mask_<live>x<M>.npy")
    sp.add_argument("--exclusive", action="store_true",
                    help="one attribute per Gaussian, its most-voted (the reference: every voted attribute)")
    sp.add_argument("--depth-window", type=float, nargs=2, default=(-0.1, 1.0), metavar=("LOW", "HIGH"),
                    help="depth-consistency window as fractions of the Gaussian depth (the reference's -0.1 1.0)")
    sp = dataset_verb("eval", "evaluate PSNR / SSIM / LPIPS over the eval split")
    sp.add_argument("--dump-images", default="", help="write gt|pred PNGs here")
    sp.add_argument("--report", default="", help="also write the JSON report to this path")
    sp.add_argument("--stage1-checkpoint", default="",
                    help="evaluate the stage-2 control model over this stage-1 checkpoint (with --gaussian-mask)")
    sp.add_argument("--gaussian-mask", default="")
    sp = dataset_verb("render", "render RGB and depth over cameras")
    sp.add_argument("--out", default="renders")
    sp.add_argument("--path", choices=["dataset", "orbit"], default="dataset",
                    help="the dataset's cameras or an orbit around the scene")
    sp.add_argument("--num-frames", type=int, default=60)
    sp.add_argument("--orbit-radius", type=float, default=0.0, help="0: the cameras' mean distance")
    sp = dataset_verb("export", "export the live Gaussians (INRIA ply, or a reference torch checkpoint)")
    sp.add_argument("--out", required=True)
    sp.add_argument("--format", choices=["ply", "torch"], default="ply")

    sp = sub.add_parser("viewer", help="serve the interactive orbit viewer")
    data_flags(sp, "this port's checkpoint directory to serve (its latest step): stage 1, or with "
                   "--stage1-checkpoint a stage-2 directory")
    sp.add_argument("--stage1-checkpoint", default="",
                    help="serve the stage-2 control model over this stage-1 checkpoint (with --data)")
    sp.add_argument("--checkpoint", default="", help="serve a reference-format .ckpt")
    sp.add_argument("--gaussian-mask", default="",
                    help="gaussian_mask_NxM.npy: the stage-2 cluster mask (with --checkpoint, the checkpoint "
                         "must carry control.* keys)")
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


def viewer_route(args) -> str:
    """The viewer's route, "stage1", "stage2" or "reference"; exits non-zero
    unless exactly one is given."""
    routes = [name for name, given in (
        ("reference", bool(args.checkpoint)),
        ("stage2", bool(args.stage1_checkpoint)),
        ("stage1", bool(args.data or args.load) and not args.stage1_checkpoint),
    ) if given]
    if len(routes) != 1:
        raise SystemExit(
            "freegaussian-tpu-torch viewer: give exactly one route: --data [--load <checkpoint dir>] (stage 1), "
            "--data --stage1-checkpoint <checkpoint dir> [--gaussian-mask] [--load] (stage 2), or "
            f"--checkpoint <reference .ckpt> [--gaussian-mask] (given: {', '.join(routes) or 'none'})"
        )
    if routes[0] != "reference" and not args.data:
        raise SystemExit("freegaussian-tpu-torch viewer: the stage-1 and stage-2 routes build a trainer over --data")
    if routes[0] == "stage1" and args.gaussian_mask:
        raise SystemExit("freegaussian-tpu-torch viewer: --gaussian-mask serves stage 2: add --stage1-checkpoint")
    return routes[0]


def serve_viewer(args):
    """Build the viewer of `args`' route and start it in the background;
    returns (the served trainer or model, the server)."""
    route = viewer_route(args)
    if route == "reference":
        return start_viewer(
            Path(args.checkpoint), port=args.port, width=args.width, height=args.height, device=args.device,
            host=args.host, gaussian_mask=Path(args.gaussian_mask) if args.gaussian_mask else None,
            deform_impl=args.deform_impl or SplatConfig.deform_impl,
        )
    trainer = _build_trainer(args, route == "stage2")
    return trainer, trainer.start_viewer(port=args.port, width=args.width, height=args.height, host=args.host)


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
    if getattr(args, "max_iterations", 0):
        cfg = dataclasses.replace(cfg, max_num_iterations=args.max_iterations)
    if args.capacity:
        cfg = dataclasses.replace(cfg, capacity=args.capacity)
    return cfg


def _resolve_device(args):
    from .device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"freegaussian-tpu-torch {args.cmd}: {e}") from None


def _build_trainer(args, control: bool):
    """The `Trainer` (or, with `control`, the `ControlTrainer` over
    `--stage1-checkpoint`) of a verb's flags, with `--load` loaded."""
    device = _resolve_device(args)
    cfg = trainer_config(args)
    if not control:
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
    return trainer


def _train(args):
    """Build the verb's trainer, train, save the last step; returns the last
    logged metrics."""
    trainer = _build_trainer(args, args.cmd == "train-control")
    metrics = trainer.train()
    trainer.save(int(trainer.state.step))
    return trainer, metrics


def cluster_inputs(trainer, key_frames: str = "", scene: str = ""):
    """The cluster vote's per-frame inputs over the trainer's dataset: (the
    (H, W, M+1) attribute masks, the cameras, the parsed mask valids), each
    by frame index, for the key frames of `scene` in the `key_frames` yaml,
    else every frame; frames without a mask are left out."""
    from .preprocess.key_frames import load_key_frames

    frames = trainer.datamanager.frames
    frame_ids = load_key_frames(Path(key_frames), scene) if key_frames and scene else range(len(frames))
    parsed_valids = trainer.parsed.mask_valids
    masks, cameras, valids = {}, {}, {}
    for i in frame_ids:
        if frames[i].atrb_mask is None:
            continue
        masks[i] = frames[i].atrb_mask
        cameras[i] = frames[i].camera
        if parsed_valids is not None:
            valids[i] = parsed_valids[i]
    return masks, cameras, valids


def _interflow(args):
    from .preprocess.epipolar_flow import generate_interflow_dataset

    n = generate_interflow_dataset(Path(args.data), interval=args.interval, form=args.form,
                                   dataparser=args.dataparser, flow_dir=args.flow_dir, device=_resolve_device(args))
    print(f"wrote {n} interflow maps")
    return n


def _cluster(args):
    from .preprocess.cluster_viz import export_cluster_ply
    from .preprocess.clustering import cluster_gaussians, save_gaussian_mask

    trainer = _build_trainer(args, False)
    st = trainer.state
    masks, cameras, valids = cluster_inputs(trainer, args.key_frames, args.scene)
    mask = cluster_gaussians(
        st.params, st.alive, masks, cameras, deform=st.deform if args.dynamic else None,
        mask_valids=valids or None, exclusive=args.exclusive,
        depth_low=args.depth_window[0], depth_high=args.depth_window[1],
    )
    n_live = int(st.alive.sum())
    out = Path(args.out) if args.out else Path(args.data) / f"gaussian_mask_{n_live}x{mask.shape[1]}.npy"
    save_gaussian_mask(out, mask, st.alive)
    export_cluster_ply(out.with_suffix(".ply"), st.params["means"], mask, st.alive)
    print(f"wrote {out} and cluster PLY")
    return trainer


def _eval(args):
    trainer = _build_trainer(args, bool(args.stage1_checkpoint))
    result = trainer.eval_all(dump_dir=Path(args.dump_images) if args.dump_images else None)
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return trainer


def _render(args):
    from .data.cameras import orbit_camera_path
    from .preprocess.render_offline import render_color_images, render_depth_maps

    trainer = _build_trainer(args, False)
    st = trainer.state
    cams = [f.camera for f in trainer.datamanager.frames]
    if args.path == "orbit":
        cams = orbit_camera_path(cams, num_frames=args.num_frames, radius=args.orbit_radius or None)
    out = Path(args.out)
    cfg = trainer.config.splat
    render_color_images(cfg, st.params, st.alive, cams, out / "rgb", deform=st.deform)
    render_depth_maps(cfg, st.params, st.alive, cams, out / "depth",
                      dataparser_scale=trainer.parsed.dataparser_scale, deform=st.deform)
    print(f"rendered {len(cams)} views to {out}")
    return trainer


def _export(args):
    trainer = _build_trainer(args, False)
    st = trainer.state
    out = Path(args.out)
    if args.format == "ply":
        from .data.splat_export import export_splat_ply

        n = export_splat_ply(out, st.params, st.alive)
        print(f"wrote {n} gaussians to {out}")
    else:
        from .models.torch_compat import export_reference_checkpoint

        export_reference_checkpoint(out, st.params, st.alive, deform=st.deform, control=st.control, step=int(st.step))
        print(f"wrote reference checkpoint to {out}")
    return trainer


_DATASET_VERBS = {"cluster": _cluster, "eval": _eval, "render": _render, "export": _export}


def main(argv=None):
    """Run a verb; every verb but `viewer` and `interflow` (the count of maps
    it wrote) returns its trainer (for callers in process, such as
    chip_smoke.py)."""
    args = build_parser().parse_args(argv)
    if args.cmd == "interflow":
        return _interflow(args)
    if args.cmd in ("train", "train-control"):
        trainer, metrics = _train(args)
        print(json.dumps(metrics))
        return trainer
    elif args.cmd in _DATASET_VERBS:
        return _DATASET_VERBS[args.cmd](args)
    elif args.cmd == "viewer":
        _, server = serve_viewer(args)
        print("serving; ctrl-c to stop")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.shutdown()


if __name__ == "__main__":
    main()
