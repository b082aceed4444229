"""Where one viewer request's time goes, for the PyTorch port on one NVIDIA GPU.

    python3 profile_serve.py

Builds the scene of `chip_smoke.py` (100k Gaussians at the bench.py
operating point, a full 8x256 bf16 deform field), then for each frame size
(640x480 and the native 1296x968, tile 32 as SplatConfig serves):

  request   host clock around `render_orbit_view` (forward, copy to the
            host, PNG encode), median of REPS
  layers    the same calls with every layer wrapped in
            `torch.cuda.synchronize()` and a host clock: deform field,
            projection, SH, binning, compositor, copy + quantize, PNG encode;
            the rest of the request is the glue between them (median of REPS)
  device    one `torch.profiler` window over REPS requests: the summed time
            of the device's own events (kernels and copies, one stream) over
            the window's wall time (the device busy share), and the heaviest
            of them by device time

The layer timings add synchronizations the plain request does not have, so
they sum to more than the request; the request and the device share come
from runs without them. One JSON line per frame size, then the card's name
and power limit. Needs a CUDA GPU and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import chip_smoke

REPS = 10
SIZES = ((640, 480), (1296, 968))
VIEW = dict(theta=0.8, phi=0.3, radius=4.0, time=0.25)
DEVICE = "cuda"


def _timed_layers():
    """Wrap each layer of the serving path so it synchronizes and adds its
    host time to the returned dict; returns (times, undo)."""
    import torch

    from freegaussian_tpu_torch.models import fields
    from freegaussian_tpu_torch.ops import rasterize, rasterize_cuda
    from freegaussian_tpu_torch.viewer import server

    times = defaultdict(float)
    patched = [
        (fields.DeformField, "forward", "deform"),
        (rasterize, "project_gaussians", "projection"),
        (rasterize, "sh_colors_for_camera", "sh"),
        (rasterize_cuda, "build_intersections", "binning"),
        (rasterize_cuda, "rasterize_tiles", "compositor"),
        (server, "to_rgb8", "copy+quantize"),
        (server, "encode_png", "png"),
    ]
    originals = []
    for owner, attr, label in patched:
        fn = getattr(owner, attr)
        originals.append((owner, attr, fn))

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[_label] += (time.perf_counter() - t0) * 1e3
            return out

        setattr(owner, attr, wrapped)

    def undo():
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)

    return times, undo


def profile_size(model, width: int, height: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from freegaussian_tpu_torch.viewer.server import model_render_fn, render_orbit_view

    render_fn = model_render_fn(model)

    def request():
        return render_orbit_view(render_fn, width=width, height=height, device=DEVICE, **VIEW)

    for _ in range(3):
        request()
    torch.cuda.synchronize()

    req_ms = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        request()
        req_ms.append((time.perf_counter() - t0) * 1e3)

    layer_runs = defaultdict(list)
    totals = []
    for _ in range(REPS):
        times, undo = _timed_layers()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            request()
            totals.append((time.perf_counter() - t0) * 1e3)
        finally:
            undo()
        for k, v in times.items():
            layer_runs[k].append(v)
    layers = {k: statistics.median(v) for k, v in layer_runs.items()}
    layers["glue"] = statistics.median(totals) - sum(layers.values())

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            request()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        # only the device's own events (kernels, copies): a CPU op's device
        # time is that of the kernels it launched, which are listed as well
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            kernels.append((dev_us / 1e3 / REPS, ev.count // REPS, ev.key[:80]))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    return {
        "size": f"{width}x{height}",
        "request_ms_median": statistics.median(req_ms),
        "request_ms_all": req_ms,
        "layers_ms_median_synced": layers,
        "device_ms_per_request": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / (window_ms / REPS) if kernels else "not measured",
        "top_kernels_ms_per_request": [[round(ms, 4), n, name] for ms, n, name in kernels[:12]],
    }


def main():
    chip_smoke.preflight()
    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint

    # the kernels build at first use, inside the warm-up requests
    with tempfile.TemporaryDirectory(prefix="profile_serve_") as tmp:
        ckpt = chip_smoke.write_scene_checkpoint(Path(tmp) / "step-000030000.ckpt", chip_smoke.N_GAUSS)
        model = load_reference_checkpoint(ckpt, device=DEVICE)
    for width, height in SIZES:
        print(json.dumps(profile_size(model, width, height)))
    print(
        subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    )


if __name__ == "__main__":
    sys.exit(main())
