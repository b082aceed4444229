"""Command-line entry of the port. It has the `viewer` verb:

    python -m freegaussian_tpu_torch.cli viewer --checkpoint step-000030000.ckpt \
        [--gaussian-mask gaussian_mask_NxM.npy] [--deform-impl fused|pallas|headsfused] \
        [--width 480] [--height 360] [--port 7007] [--host 0.0.0.0] [--device cuda]

It serves a reference-format checkpoint (what the JAX package writes with
`export --format torch`) through the HTTP viewer: a stage-1 checkpoint, or
with `--gaussian-mask` a stage-2 checkpoint (one with `control.*` keys) and
its cluster mask, whose attribute sliders drive the control field.
`--deform-impl` sets `SplatConfig.deform_impl` ("pallas" runs the deform and
control trunks on the field-trunk kernels). The dataset-bound verbs (train,
eval, render, cluster, ...) come with later slices.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

from .models.splat_model import SplatConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="freegaussian-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "viewer":
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
