"""Where one viewer request's time goes, for the PyTorch port on one NVIDIA
GPU.

    python3 profile_serve.py          # serving
    python3 profile_serve.py stage2   # serving the stage-2 slider viewer

Builds the scene of `chip_smoke.py` (100k Gaussians at the bench.py
operating point, a full 8x256 bf16 deform field), and for `stage2` its
stage-2 scene (the seeded control field and cluster mask, with deform_impl
"pallas": the deform and control trunks on the field-trunk kernels).

Serving, for each frame size (640x480 and the native 1296x968, tile 32 as
SplatConfig serves):

  request   host clock around `render_orbit_view` (forward, copy to the
            host, JPEG encode), median of REPS
  layers    the same calls with every layer wrapped in
            `torch.cuda.synchronize()` and a host clock: deform field,
            projection, SH, binning, compositor, copy + quantize, JPEG encode;
            the rest of the request is the glue between them (median of REPS)
  device    one `torch.profiler` window over REPS requests: the summed time
            of the device's own events (kernels and copies, one stream) over
            the window's wall time (the device busy share), and the heaviest
            of them by device time

`stage2` times requests at 640x480 with the sliders at
`chip_smoke.SLIDERS[0]` in the same way, the control field taking the
deform field's place among the layers. A training step's phases come from
the trainer's own marks (`freegaussian_tpu_torch/utils/profiling.py`).

The layer timings add synchronizations the plain request does not have, so
they sum to more; the request and the device share come from runs without
them. One JSON line per frame size, then the card's name and power limit.
Needs a CUDA GPU and nvcc; exits non-zero without them.
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


def _wrap_layers(patched):
    """Wrap (owner, attr, label) so each call synchronizes and adds its host
    time to the returned dict under its label; returns (times, undo)."""
    import torch

    times = defaultdict(float)
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
        for owner, attr, fn in reversed(originals):
            setattr(owner, attr, fn)

    return times, undo


def _device_window(fn, reps: int) -> dict:
    """One torch.profiler window over `reps` calls of fn: the device's own
    events per call, their share of the wall time, the heaviest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
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
            kernels.append((dev_us / 1e3 / reps, ev.count // reps, ev.key[:80]))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    return {
        "device_ms_per_call": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / (window_ms / reps) if kernels else "not measured",
        "device_events_per_call": sum(k[1] for k in kernels),
        "top_kernels_ms_per_call": [[round(ms, 4), n, name] for ms, n, name in kernels[:12]],
    }


def _synced_layers(call, patched) -> dict:
    """Median per-layer host ms of REPS calls with each layer synced; the
    glue is the call less all layers."""
    import torch

    runs, totals = defaultdict(list), []
    for _ in range(REPS):
        times, undo = _wrap_layers(patched)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            totals.append((time.perf_counter() - t0) * 1e3)
        finally:
            undo()
        for k, v in times.items():
            runs[k].append(v)
    layers = {k: statistics.median(v) for k, v in runs.items()}
    layers["glue"] = statistics.median(totals) - sum(layers.values())
    return layers


def _median_ms(fn, warmup: int = 1) -> tuple:
    """(median ms, all ms) of REPS calls of fn after `warmup` calls."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def profile_size(model, width: int, height: int, stage2: bool = False) -> dict:
    """One frame size's request, layers and device window; with `stage2`
    the slider viewer over the stage-2 model at `chip_smoke.SLIDERS[0]`."""
    import torch

    from freegaussian_tpu_torch.models import fields
    from freegaussian_tpu_torch.ops import rasterize, rasterize_cuda
    from freegaussian_tpu_torch.viewer import server
    from freegaussian_tpu_torch.viewer.server import control_render_fn, model_render_fn, render_orbit_view

    render_fn = control_render_fn(model) if stage2 else model_render_fn(model)
    atrb = 0.1 * chip_smoke.SLIDERS[0] if stage2 else None

    def request():
        return render_orbit_view(render_fn, width=width, height=height, device=DEVICE, atrb_values=atrb, **VIEW)

    req_med, req_ms = _median_ms(request, warmup=3)

    patched = [
        (fields.ControlField, "forward", "control") if stage2 else (fields.DeformField, "forward", "deform"),
        (rasterize, "project_gaussians", "projection"),
        (rasterize, "sh_colors_for_camera", "sh"),
        (rasterize_cuda, "build_intersections", "binning"),
        (rasterize_cuda, "rasterize_tiles", "compositor"),
        (server, "to_rgb8", "copy+quantize"),
        (server, "encode_jpeg", "jpeg"),
    ]
    layers = _synced_layers(request, patched)
    window = _device_window(request, REPS)
    return {
        "size": f"{width}x{height}" + (" stage2 sliders" if stage2 else ""),
        "request_ms_median": req_med,
        "request_ms_all": req_ms,
        "layers_ms_median_synced": layers,
        "device_ms_per_request": window["device_ms_per_call"],
        "device_busy_share": window["device_busy_share"],
        "top_kernels_ms_per_request": window["top_kernels_ms_per_call"],
    }


def main():
    chip_smoke.preflight()
    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint

    mode = sys.argv[1:]
    if mode not in ([], ["stage2"]):
        sys.exit(f"usage: {sys.argv[0]} [stage2]")
    # the kernels build at first use, inside the warm-up requests
    with tempfile.TemporaryDirectory(prefix="profile_serve_") as tmp:
        ckpt = chip_smoke.write_scene_checkpoint(Path(tmp) / "step-000030000.ckpt", chip_smoke.N_GAUSS)
        model = load_reference_checkpoint(ckpt, device=DEVICE)
        if mode == ["stage2"]:
            _, _, model2 = chip_smoke.phase_scene2(Path(tmp), model)
    if mode == ["stage2"]:
        print(json.dumps(profile_size(model2, *chip_smoke.SERVE_WH, stage2=True)))
    else:
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
