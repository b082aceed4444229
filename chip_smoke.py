"""Smoke run of the PyTorch port (`freegaussian_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's stage-1 serving path (reference checkpoint ->
`forward(train=False)` -> HTTP viewer) with every kernel built from this
checkout. Phases, printed as each ends:

  1. device   the card's name and power limit, as nvidia-smi gives them
  2. build    nvcc builds every kernel source of the path, all at once
  3. scene    a seeded synthetic scene at the bench.py operating point
              (100k Gaussians, SH degree 3, scales log(0.015), the 50/30/20
              opacity mixture, a full 8x256 deform field with heads x 0.01),
              written as a reference checkpoint and loaded back
  4. kernels  each kernel against its plain PyTorch version on the inputs
              the main path gives it (640x480; C = 3 and 4; tiles 16 and
              32): max |diff|, kernel and plain ms (CUDA events), and the
              least time the card could take (the bound)
  5. serve    the main path: the HTTP viewer answers GET /render at 640x480
              (tile 32), then at the native 1296x968 (tile 16 and 32), each
              frame through the kernel; the launch counts are zeroed just
              before each path's requests and read just after
  6. check    a frame rendered on the GPU against the same frame from the
              port on the CPU (the path the tests hold against the JAX
              package)

Then one JSON line of kernel records and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Nothing catches a failure: any fault raises and the exit code is not 0. It
needs a CUDA GPU, nvcc ($CUDA_HOME or /usr/local/cuda) and this checkout,
and exits non-zero without them. It uses no network: the viewer binds
127.0.0.1.
"""

from __future__ import annotations

import http.client
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SEED = 0
N_GAUSS = 100_000
SERVE_WH = (640, 480)
NATIVE_WH = (1296, 968)
KERNEL_ATOL = 2e-5  # the JAX package's forward budget (tests/test_rasterize_pallas.py)
CHECK_ATOL = 1e-3  # GPU vs CPU frame: f32 GEMM and projection rounding, then compositing
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
SH_C0 = 0.28209479177387814
DEVICE = "cuda"


def die(msg: str, code: int = 2):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def preflight():
    try:
        import torch
    except ImportError:
        die("torch is not installed")
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    sys.path.insert(0, str(HERE))
    try:
        import freegaussian_tpu_torch
    except ImportError:
        die(f"the port (freegaussian_tpu_torch/) is not beside {Path(__file__).name}")
    pkg_dir = Path(freegaussian_tpu_torch.__file__).resolve().parent
    if pkg_dir.parent != HERE:
        die(f"imported freegaussian_tpu_torch from {pkg_dir}, not from this checkout")


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------


def synthetic_gaussians(n: int = N_GAUSS, seed: int = SEED, sh_degree: int = 3) -> dict:
    """The bench.py operating point as numpy arrays in the port's layout:
    N(0, 1) means, ~4 px screen radius, a trained-like bimodal opacity
    mixture (50% in [0.55, 0.99], 30% in [0.1, 0.55], 20% in [0.02, 0.1])."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    u = rng.uniform(size=n)
    op = np.where(
        u < 0.5, rng.uniform(0.55, 0.99, n), np.where(u < 0.8, rng.uniform(0.1, 0.55, n), rng.uniform(0.02, 0.1, n))
    )
    params = {
        "means": rng.normal(scale=1.0, size=(n, 3)),
        "scales": np.full((n, 3), np.log(0.015)),
        "quats": quats,
        "features_dc": (rng.uniform(size=(n, 3)) - 0.5) / SH_C0,
        "features_rest": rng.normal(scale=0.05, size=(n, (k - 1) * 3)),
        "opacities": np.log(op / (1.0 - op))[:, None],
    }
    return {name: a.astype(np.float32) for name, a in params.items()}


def synthetic_deform_state(deform, seed: int = SEED + 1, head_scale: float = 0.01) -> dict:
    """torch nn.Linear's default init, U(+-1/sqrt(fan_in)), for every layer
    of `deform`, from a numpy seed; the four output heads scaled by
    `head_scale` (trained-like small deltas, as bench.py does)."""
    from freegaussian_tpu_torch.models.fields import HEAD_NAMES

    rng = np.random.default_rng(seed)
    state = {}
    for name, p in deform.state_dict().items():
        layer = name.rsplit(".", 1)[0]
        fan_in = deform.get_submodule(layer).weight.shape[1]
        bound = 1.0 / np.sqrt(fan_in)
        a = rng.uniform(-bound, bound, size=tuple(p.shape))
        if layer in HEAD_NAMES:
            a = a * head_scale
        state[name] = a.astype(np.float32)
    return state


def write_scene_checkpoint(path: Path, n: int = N_GAUSS) -> Path:
    """Write the synthetic scene with `export_reference_checkpoint` at step
    30000 (past the deform warm-up)."""
    import torch

    from freegaussian_tpu_torch.models.splat_model import SplatConfig, SplatModel
    from freegaussian_tpu_torch.models.torch_compat import export_reference_checkpoint

    model = SplatModel(SplatConfig(), n, device="cpu")
    state = {f"gauss_params.{k}": torch.from_numpy(v) for k, v in synthetic_gaussians(n).items()}
    state["alive"] = torch.ones(n, dtype=torch.bool)
    for k, v in synthetic_deform_state(model.deform).items():
        state[f"deform.{k}"] = torch.from_numpy(v)
    model.load_state_dict(state, strict=True)
    return export_reference_checkpoint(path, model.params, model.alive, deform=model.deform, step=30000)


def bench_camera(width: int, height: int, device, time_: float = 0.5):
    """bench.py's camera: 6 units from the origin, focal 500 at 640 px wide
    (a constant field of view at any resolution)."""
    import torch

    from freegaussian_tpu_torch.data.cameras import Camera

    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 6.0
    focal = 500.0 * width / 640.0

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return Camera(
        c2w=t(c2w), fx=t(focal), fy=t(focal), cx=t(width / 2.0), cy=t(height / 2.0),
        time=t(time_), width=width, height=height,
    )


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of `fn` in ms, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compositor_bound(n: int, channels: int, num_isects: int, num_tiles: int, pixels: int, pairs: int):
    """Least time (ms) the card could take for one compositor call, and what
    sets it. Bytes: each input read once (the per-Gaussian rows of means2d,
    conic, opacity, radius and C channels, one id per intersection, the tile
    offsets), each output written once (color, alpha, livecnt, t_final).
    Operations: `pairs` (pixel, intersection) pairs that must be evaluated
    (every pixel walks its 16-px tile's sorted run up to its termination:
    the sum of livecnt at tile 16) times 22 + 2C f32 operations each (11 for
    sigma, 4 for alpha with its exp, 2 tests, 3 for the transmittance step,
    1 for the weight, 2C + 1 to accumulate)."""
    bytes_ = 4 * (n * (7 + channels) + num_isects + num_tiles + 1 + pixels * (channels + 3))
    ops = pairs * (22 + 2 * channels)
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def http_get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(out)
    return out


def phase_build():
    from freegaussian_tpu_torch.cuda_build import build
    from freegaussian_tpu_torch.ops.rasterize_cuda import KERNEL_SOURCES

    for name in KERNEL_SOURCES:
        seconds = build(name)
        took = "already built" if seconds is None else f"{seconds:.1f} s"
        print(f"build: {name} ({took}, sm_90a)")


def phase_scene(tmp: Path):
    import torch

    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint

    t0 = time.perf_counter()
    path = write_scene_checkpoint(tmp / "step-000030000.ckpt", N_GAUSS)
    model = load_reference_checkpoint(path, device=DEVICE)
    want = synthetic_gaussians(N_GAUSS)
    for name, arr in want.items():
        if not np.array_equal(model.params[name].cpu().numpy(), arr):
            raise AssertionError(f"checkpoint round trip changed {name}")
    assert int(model.alive.sum()) == N_GAUSS and model.step == 30000
    assert model.deform.compute_dtype == torch.bfloat16
    print(
        f"scene: {N_GAUSS} Gaussians, SH degree {model.cfg.sh_degree}, deform 8x256 bf16, "
        f"checkpoint {path.stat().st_size / 2**20:.1f} MiB, written and loaded in {time.perf_counter() - t0:.1f} s"
    )
    return path, model


def phase_kernels(model) -> dict:
    """The compositor against its plain version on the main path's inputs."""
    import torch

    from freegaussian_tpu_torch.ops import rasterize as rasterize_mod
    from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_tiles, rasterize_tiles_plain
    from freegaussian_tpu_torch.ops.tiles import build_intersections

    width, height = SERVE_WH
    pixel_stage = rasterize_mod.rasterize_pixels
    captured = []

    def capture(*args, **kwargs):
        captured.append(args)
        return pixel_stage(*args, **kwargs)

    rasterize_mod.rasterize_pixels = capture
    try:
        model(bench_camera(width, height, DEVICE))
    finally:
        rasterize_mod.rasterize_pixels = pixel_stage
    m2d, con, chans, opac, depths, radii = (a.float().contiguous() for a in captured[0][:6])
    n = m2d.shape[0]
    assert chans.shape == (n, 4), chans.shape  # RGB+ED at serving time

    rows = []
    pairs16 = None
    for tile in (16, 32):  # 16 first: its livecnt sets the bound's pair count
        isect = build_intersections(m2d, radii, depths, width, height, tile)
        for C in (3, 4):
            col = chans[:, :C].contiguous()
            args = (m2d, con, col, opac, radii, isect.gauss_ids, isect.tile_offsets, width, height, tile)
            got = rasterize_tiles(*args)
            torch.cuda.synchronize()
            want = rasterize_tiles_plain(*args)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want) if a.dtype == torch.float32)
            over = int(((got[0] - want[0]).abs().amax(-1) > 1e-6).sum())
            live_diff = int((got[2] != want[2]).sum())
            if pairs16 is None:
                pairs16 = int(got[2].long().sum())
            k_ms = cuda_ms(lambda: rasterize_tiles(*args), reps=25)
            p_ms = cuda_ms(lambda: rasterize_tiles_plain(*args), reps=3, warmup=1)
            bound_ms, bound_by = compositor_bound(n, C, isect.num_isects, isect.num_tiles, width * height, pairs16)
            row = dict(
                tile=tile, C=C, num_isects=isect.num_isects, max_abs_err=err, pixels_over_1e6=over,
                livecnt_mismatch=live_diff, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
            )
            print("kernel rasterize_fwd " + json.dumps(row))
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"kernel vs plain at tile {tile}, C={C}: max |diff| {err} > {KERNEL_ATOL}")
            if live_diff:
                raise AssertionError(f"kernel vs plain at tile {tile}, C={C}: livecnt differs at {live_diff} pixels")
            rows.append(row)
    print(f"kernel pairs evaluated (sum of livecnt at tile 16, {width}x{height}): {pairs16}; library_ms: null")
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def _serve(model, width: int, height: int, views, label: str):
    """Start a viewer over `model`, GET /render for each view, check every
    answer, shut it down. The launch counts are zeroed just before the
    requests and read just after. Returns (request latencies in ms, launches)."""
    from freegaussian_tpu_torch.ops.rasterize_cuda import LAUNCHES
    from freegaussian_tpu_torch.viewer.png import decode_png
    from freegaussian_tpu_torch.viewer.server import ViewerServer, model_render_fn

    server = ViewerServer(model_render_fn(model), width=width, height=height, port=0, host="127.0.0.1", device=DEVICE)
    server.start_background()
    latencies = []
    try:
        assert http_get(server.port, "/")[0] == 200
        status, _, body = http_get(server.port, "/info")
        assert status == 200 and json.loads(body) == {"num_attributes": 0}
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for th, ph, r, t in views:
            before = sum(LAUNCHES.values())
            t0 = time.perf_counter()
            status, ctype, body = http_get(server.port, f"/render?th={th}&ph={ph}&r={r}&t={t}")
            ms = (time.perf_counter() - t0) * 1e3
            assert status == 200 and ctype == "image/png", (status, ctype)
            img = decode_png(body)
            assert img.shape == (height, width, 3), img.shape
            assert img.std() > 1.0 and len(np.unique(img.reshape(-1, 3), axis=0)) > 100, "constant frame"
            launched = sum(LAUNCHES.values()) - before
            assert launched == 1, f"{launched} kernel launches for one request"
            latencies.append(ms)
            print(f"serve {label} {width}x{height} th={th} ph={ph} r={r} t={t}: 200 image/png {len(body)} B in {ms:.1f} ms")
        launches = dict(LAUNCHES)
    finally:
        server.shutdown()
    for name, count in launches.items():
        if count != len(views):
            raise AssertionError(f"kernel {name}: {count} launches in {len(views)} requests on the {label} path")
    return latencies, launches


def phase_serve(model, ckpt: Path) -> dict:
    """The main path (640x480, tile 32 as SplatConfig serves), then the
    native frame size at tile 16 and 32; each path's launches are its own."""
    import dataclasses

    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint

    model16 = load_reference_checkpoint(ckpt, cfg=dataclasses.replace(model.cfg, tile_size=16), device=DEVICE)
    views = [(0.0, 0.0, 4.0, 0.0), (0.8, 0.3, 4.0, 0.25), (-1.2, -0.4, 3.5, 0.5), (2.5, 0.9, 5.0, 0.75), (3.1, -1.0, 4.5, 1.0)]
    (w, h), (nw, nh) = SERVE_WH, NATIVE_WH
    paths = {
        "main": (f"{w}x{h} tile 32", _serve(model, w, h, views, "main")),
        # 81 x 61 = 4941 tiles of 16 px at 1296x968: the exact two-key sort
        "native16": (f"{nw}x{nh} tile 16", _serve(model16, nw, nh, views[:3], "native16")),
        "native32": (f"{nw}x{nh} tile 32", _serve(model, nw, nh, views[:3], "native32")),
    }
    for label, (what, (lat, launches)) in paths.items():
        # the first request of each server pays its first-use costs; the rest are steady
        print(
            f"serve {label} ({what}): {len(lat)} requests, launches {json.dumps(launches)}, "
            f"latency first {lat[0]:.1f} ms, median of the rest {statistics.median(lat[1:]):.1f} ms"
        )
    return {label: {"path": what, "latency_ms": lat, "launches": launches} for label, (what, (lat, launches)) in paths.items()}


def phase_check(ckpt: Path):
    """The same frame on the GPU (kernel) and on the CPU (plain version), at
    a small size, with the deform field in f32 so the two differ only by
    f32 rounding."""
    import torch

    from freegaussian_tpu_torch.models.splat_model import SplatConfig
    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint
    from freegaussian_tpu_torch.viewer.server import orbit_camera

    cfg = SplatConfig(deform_bf16=False)
    outs = {}
    for dev in (DEVICE, "cpu"):
        model = load_reference_checkpoint(ckpt, cfg=cfg, device=dev)
        cam = orbit_camera(0.7, 0.2, 4.0, width=160, height=120, time=0.3, device=dev)
        out = model(cam)
        outs[dev] = {k: out[k].float().cpu() for k in ("rgb", "accumulation", "depth")}
    g, c = outs[DEVICE], outs["cpu"]
    assert g["rgb"].shape == (120, 160, 3) and g["accumulation"].shape == g["depth"].shape == (120, 160, 1)
    for k in g:
        assert torch.isfinite(g[k]).all(), k
    err_rgb = float((g["rgb"] - c["rgb"]).abs().max())
    err_acc = float((g["accumulation"] - c["accumulation"]).abs().max())
    seen = c["accumulation"] > 0.5
    err_depth = float(((g["depth"] - c["depth"]).abs() / c["depth"].abs().clamp(min=1e-6))[seen].max())
    print(
        f"check 160x120 GPU vs CPU: max |rgb diff| {err_rgb:.3g}, max |accumulation diff| {err_acc:.3g}, "
        f"max depth rel diff where accumulation > 0.5: {err_depth:.3g} (limit {CHECK_ATOL})"
    )
    assert float(c["accumulation"].max()) > 0.9 and float(g["rgb"].std()) > 0.01, "empty frame"
    if not max(err_rgb, err_acc, err_depth) <= CHECK_ATOL:
        raise AssertionError("GPU frame differs from the CPU frame")


def main():
    preflight()
    import torch

    from freegaussian_tpu_torch.ops import rasterize_cuda

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt, model = phase_scene(Path(tmp))
        kern = phase_kernels(model)
        serve = phase_serve(model, ckpt)
        phase_check(ckpt)
    main_row = next(r for r in kern["rows"] if r["tile"] == model.cfg.tile_size and r["C"] == 4)
    record = {
        "name": "rasterize_fwd",
        "route": "cuda",
        "source": "freegaussian_tpu_torch/csrc/rasterize_fwd.cu",
        "replaces": "freegaussian_tpu/ops/rasterize_pallas.py:523",
        "launches": serve["main"]["launches"]["rasterize_fwd"],
        "max_abs_err": kern["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }
    assert [record["name"]] == list(rasterize_cuda.LAUNCHES)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
            }
        )
    )


if __name__ == "__main__":
    main()
