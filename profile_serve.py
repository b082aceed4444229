"""Where one viewer request's time goes, and one training step's, for the
PyTorch port on one NVIDIA GPU.

    python3 profile_serve.py          # serving
    python3 profile_serve.py train    # the stage-1 training step
    python3 profile_serve.py stage2   # serving the stage-2 slider viewer
    python3 profile_serve.py train2   # the stage-2 (control) training step
    python3 profile_serve.py graphs   # the graphed steps and the eval sweep at the verbs' capacity

Builds the scene of `chip_smoke.py` (100k Gaussians at the bench.py
operating point, a full 8x256 bf16 deform field), and for the stage-2
modes its stage-2 scene (the seeded control field and cluster mask, with
deform_impl "pallas": the deform and control trunks on the field-trunk
kernels).

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

Training, the step of `chip_smoke.py`'s train phase (640x480, tile 32,
flow losses on), after 3 warm-up steps:

  step      host clock around `step_fn` ending in a synchronize, median of REPS
  layers    the same steps with each layer synced and host-timed: deform
            forward (two calls: t and the paired t0), projection (three
            calls: the render and the two flow projections), SH, binning,
            compositor forward, SSIM + L1, flow losses, the whole backward,
            inside it the deform field's backward kernels (two calls), the
            compositor backward and the per-Gaussian reduction, Adam,
            densification statistics; "backward other" is the backward less
            those three (the screw-axis, projection, SH and loss backwards),
            and the glue is the step less all layers
  deform    the deform field's forward and its backward alone, synced, on
            the step's inputs (median of REPS), since autograd runs its
            backward inside the backward layer
  device    one `torch.profiler` window over REPS steps, as for serving

Stage 2: `stage2` times requests at 640x480 with the sliders at
`chip_smoke.SLIDERS[0]` as for serving, the control field taking the deform
field's place among the layers; `train2` times the step of `chip_smoke.py`'s
train2 phase as for training, with the layers control state (the two
deform-trunk calls), control field forward, projection, SH, binning,
compositor forward, SSIM + L1, the backward (inside it the field trunk's
backward, the compositor backward and the reduction) and Adam.

`graphs` runs `chip_smoke.py`'s phases 24 and 25 alone over its phase-13
dataset (the bench scene loaded into the verbs' trainers, capacity 2^18,
1e5 alive): both stages with `scan_chunk` 10 against the eager loop, and
the eval sweep of both stages against the per-frame loop, then one JSON
line of their device ms a step or a frame, the field kernels' ms from the
profiler windows, wall ms a step and frames/s. It reads `chip_smoke` from
this file's directory, so a copy of this file beside another checkout's
`chip_smoke.py` (one with the same phase functions) measures that
checkout: two trees compare in one call.

The layer timings add synchronizations the plain request or step does not
have, so they sum to more; the request, the step and the device share come
from runs without them. One JSON line per frame size (or one for the step),
then the card's name and power limit. Needs a CUDA GPU and nvcc; exits
non-zero without them.
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


def _synced_layers(call, patched, inner=()) -> dict:
    """Median per-layer host ms of REPS calls with each layer synced; the
    "backward" layer less its `inner` layers becomes "backward other", and
    the glue is the call less all layers."""
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
    if inner:
        # the backward holds these: count each once
        layers["backward other"] = layers.pop("backward") - sum(layers[k] for k in inner)
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


def profile_train2(model2) -> dict:
    """The stage-2 step, as `profile_train` times the stage-1 one."""
    import torch

    from freegaussian_tpu_torch.engine import control_train_step
    from freegaussian_tpu_torch.models import control_model, fields
    from freegaussian_tpu_torch.ops import mlp_cuda, rasterize, rasterize_cuda

    width, height = chip_smoke.SERVE_WH
    state, step_fn, camera, batch = chip_smoke.build_control_train_case(model2, width, height)

    def step():
        step_fn(state, camera, batch, 3)
        torch.cuda.synchronize()

    step_med, step_ms = _median_ms(step, warmup=3)
    patched = [
        (control_model, "control_state_from_deform", "control state"),
        (fields.ControlField, "forward", "control fwd"),
        (rasterize, "project_gaussians", "projection"),
        (rasterize, "sh_colors_for_camera", "SH"),
        (rasterize_cuda, "build_intersections", "binning"),
        (rasterize_cuda, "rasterize_tiles", "compositor fwd"),
        (control_train_step, "loss_fn", "SSIM + L1"),
        (torch.autograd, "grad", "backward"),
        (mlp_cuda, "field_trunk_bwd", "field bwd"),
        (rasterize_cuda, "rasterize_tiles_bwd", "compositor bwd"),
        (rasterize_cuda, "reduce_rows_by_gid", "reduction"),
        (control_train_step, "apply_group_updates", "Adam"),
    ]
    out = {
        "mode": f"train2 {width}x{height} tile {model2.cfg.tile_size} deform_impl {model2.cfg.deform_impl}",
        "step_ms_median": step_med,
        "step_ms_all": step_ms,
        "train_step_pixels_per_sec": width * height / (step_med / 1e3),
        "layers_ms_median_synced": _synced_layers(step, patched, ("field bwd", "compositor bwd", "reduction")),
    }
    out.update(_device_window(step, REPS))
    return out


def profile_train(model) -> dict:
    import torch

    from freegaussian_tpu_torch.engine import train_step
    from freegaussian_tpu_torch.models import fields, splat_model
    from freegaussian_tpu_torch.ops import mlp_cuda, rasterize, rasterize_cuda

    width, height = chip_smoke.SERVE_WH
    state, step_fn, camera, camera0, batch = chip_smoke.build_train_case(model, width, height)
    state_tile = splat_model.SplatConfig(**chip_smoke.TRAIN_MODEL).tile_size

    def step():
        step_fn(state, camera, batch, 3, camera0=camera0)
        torch.cuda.synchronize()

    step_med, step_ms = _median_ms(step, warmup=3)

    patched = [
        (fields.DeformField, "forward", "deform fwd"),
        (rasterize, "project_gaussians", "projection"),
        (splat_model, "project_gaussians", "projection"),
        (rasterize, "sh_colors_for_camera", "SH"),
        (rasterize_cuda, "build_intersections", "binning"),
        (rasterize_cuda, "rasterize_tiles", "compositor fwd"),
        (train_step, "loss_fn", "SSIM + L1"),
        (train_step, "rendered_flow_loss", "flow losses"),
        (train_step, "query_3d_gaussian_flow", "flow losses"),
        (train_step, "flow_supervision_loss", "flow losses"),
        (torch.autograd, "grad", "backward"),
        (mlp_cuda, "deform_field_bwd", "deform bwd"),
        (rasterize_cuda, "rasterize_tiles_bwd", "compositor bwd"),
        (rasterize_cuda, "reduce_rows_by_gid", "reduction"),
        (train_step, "apply_group_updates", "Adam"),
        (train_step, "update_stats", "densify stats"),
    ]
    layers = _synced_layers(step, patched, ("deform bwd", "compositor bwd", "reduction"))

    # the deform field alone: forward, then forward + backward to its weights
    deform = state.deform
    means = state.params["means"].detach()
    times_ = camera.time.reshape(1, 1)
    weights = list(deform.parameters())
    g = torch.Generator(device="cpu").manual_seed(0)

    def deform_fwd():
        with torch.no_grad():
            deform(means, times_)
        torch.cuda.synchronize()

    def outputs():
        d_xyz, d_rot, d_scale = deform(means, times_)
        return [d_xyz.w, d_xyz.v, d_xyz.theta, d_rot, d_scale]

    # seeded cotangents, made once: drawing them is no part of the field's time
    cots = [torch.randn(o.shape, generator=g).to(o.device) for o in outputs()]

    def deform_fwd_bwd():
        torch.autograd.grad(outputs(), weights, cots)
        torch.cuda.synchronize()

    fwd_ms, fwd_bwd_ms = _median_ms(deform_fwd)[0], _median_ms(deform_fwd_bwd)[0]
    out = {
        "mode": f"train {width}x{height} tile {state_tile}",
        "step_ms_median": step_med,
        "step_ms_all": step_ms,
        "train_step_pixels_per_sec": width * height / (step_med / 1e3),
        "layers_ms_median_synced": layers,
        "deform_alone_ms": {"fwd": fwd_ms, "fwd+bwd": fwd_bwd_ms, "bwd": fwd_bwd_ms - fwd_ms, "calls_per_step": 2},
    }
    out.update(_device_window(step, REPS))
    return out


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


def profile_graphs(tmp: Path, model) -> dict:
    """`chip_smoke.py`'s phases 24 and 25 over its phase-13 dataset, and
    their readings by stage: the graphed step (device ms a step, wall ms a
    step, the field kernels' and the compositor's ms a step) and the sweep
    (frames/s, device ms a frame, the kernels' ms a frame)."""
    card = chip_smoke.phase_device()
    data = chip_smoke.phase_dataset(tmp, model)
    bench = chip_smoke.bench_inputs(tmp, data, model)
    graphs = chip_smoke.phase_graphs(tmp, data, model, card, bench)
    sweep = chip_smoke.phase_sweep(tmp, data, model, card, bench)
    frames = chip_smoke.DATA_FRAMES
    out = {}
    for stage in ("stage1", "stage2"):
        g = graphs[stage]["time"]["graphed"]
        w = sweep[stage]["time"]["sweep"]
        out[stage] = {
            "graphed_device_ms_per_step": g["device_ms_per_step"],
            "graphed_wall_ms_per_step": graphs[stage]["time"]["graphed"]["wall_ms_per_step"],
            "graphed_kernels_ms_per_step": g.get("port_kernels_ms_per_step"),
            "graphed_bit_equal": graphs[stage]["check"]["bit_equal"],
            "sweep_median_fps": w["median_fps"],
            "sweep_device_ms_per_frame": w["device_ms_per_call"] / frames,
            "sweep_kernels_ms_per_frame": {k: v / frames for k, v in w.get("port_kernels_ms_per_call", {}).items()},
            "sweep_max_abs_diff": sweep[stage]["max_abs_diff"],
        }
    return out


def main():
    chip_smoke.preflight()
    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint

    # the kernels build at first use, inside the warm-up requests or steps
    with tempfile.TemporaryDirectory(prefix="profile_serve_") as tmp:
        ckpt = chip_smoke.write_scene_checkpoint(Path(tmp) / "step-000030000.ckpt", chip_smoke.N_GAUSS)
        model = load_reference_checkpoint(ckpt, device=DEVICE)
        mode = sys.argv[1:]
        if mode in (["stage2"], ["train2"]):
            _, _, model2 = chip_smoke.phase_scene2(Path(tmp), model)
        if mode == ["graphs"]:
            print(json.dumps(profile_graphs(Path(tmp), model)))
    if mode == ["train"]:
        print(json.dumps(profile_train(model)))
    elif mode == ["stage2"]:
        print(json.dumps(profile_size(model2, *chip_smoke.SERVE_WH, stage2=True)))
    elif mode == ["train2"]:
        print(json.dumps(profile_train2(model2)))
    elif mode and mode != ["graphs"]:
        sys.exit(f"usage: {sys.argv[0]} [train | stage2 | train2 | graphs]")
    elif not mode:
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
