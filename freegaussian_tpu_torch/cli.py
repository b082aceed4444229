"""Command-line entry of the port. This slice has the `viewer` verb:

    python -m freegaussian_tpu_torch.cli viewer --checkpoint step-000030000.ckpt \
        [--width 480] [--height 360] [--port 7007] [--host 0.0.0.0] [--device cuda]

It serves a reference-format checkpoint (what the JAX package writes with
`export --format torch`) through the HTTP viewer. The dataset-bound verbs
(train, eval, render, cluster, ...) come with later slices.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="freegaussian-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("viewer", help="serve the interactive orbit viewer over a reference checkpoint")
    sp.add_argument("--checkpoint", required=True, help="reference-format .ckpt")
    sp.add_argument("--port", type=int, default=7007)
    sp.add_argument("--host", default="0.0.0.0", help="address to bind (127.0.0.1: this machine only)")
    sp.add_argument("--width", type=int, default=480)
    sp.add_argument("--height", type=int, default=360)
    sp.add_argument("--device", default="cuda")
    return p


def start_viewer(checkpoint: Path, *, port: int, width: int, height: int, device: str, host: str = "0.0.0.0"):
    """Load the checkpoint and start the viewer in the background; returns
    (model, server)."""
    from .models.torch_compat import load_reference_checkpoint
    from .viewer.server import ViewerServer, model_render_fn

    model = load_reference_checkpoint(checkpoint, device=device)
    server = ViewerServer(model_render_fn(model), width=width, height=height, port=port, host=host, device=device)
    server.start_background()
    print(f"viewer: http://localhost:{server.port}/")
    return model, server


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "viewer":
        _, server = start_viewer(
            Path(args.checkpoint), port=args.port, width=args.width, height=args.height,
            device=args.device, host=args.host,
        )
        print("serving; ctrl-c to stop")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.shutdown()


if __name__ == "__main__":
    main()
