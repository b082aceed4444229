"""Smoke run of the PyTorch port (`freegaussian_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's stage-1 serving path (reference checkpoint ->
`forward(train=False)` -> HTTP viewer) and its stage-1 training step
(`make_train_step`: forward, loss, backward, Adam, densification) with every
kernel built from this checkout. Phases, printed as each ends:

  1. device   the card's name and power limit, as nvidia-smi gives them
  2. build    nvcc builds every kernel source, one process per source, all
              started together
  3. scene    a seeded synthetic scene at the bench.py operating point
              (100k Gaussians, SH degree 3, scales log(0.015), the 50/30/20
              opacity mixture, a full 8x256 deform field with heads x 0.01),
              written as a reference checkpoint and loaded back
  4. kernels  each kernel against its plain PyTorch version on the inputs
              the main paths give it (640x480; tiles 16 and 32): the
              compositor at C = 3 and 4, its backward at C = 3 and 5 with
              seeded cotangents, the fused deform field's forward (100k
              means, the scene's weights and time row) and its backward
              with a seeded cotangent: max |diff|, elements outside the
              budget, kernel and plain ms (CUDA events), and the least time
              the card could take (the bound)
  5. serve    the serving path: the HTTP viewer answers GET /render at
              640x480 (tile 32), then at the native 1296x968 (tile 16 and
              32), each frame through the deform field's forward and the
              compositor; the launch counts are zeroed just before each
              path's requests and read just after
  6. check    a frame rendered on the GPU against the same frame from the
              port on the CPU (the path the tests hold against the JAX
              package)
  7. train    the training path: 12 steps of `make_train_step` at the
              bench.py operating point (640x480, tile 32, warm-up 0) with
              the flow losses at configs/sim/base.yaml's weights against
              seeded synthetic targets, one refine inside the 12 steps; the
              loss of every step, the median step time and
              train_step_pixels_per_sec, each kernel's launches (zeroed just
              before the steps, read just after: per step one compositor and
              its backward, two deform-field forwards and backwards, at the
              frame's time and the paired frame's), and the refine's split /
              dup / cull counts

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
# the JAX package's gradient budget; at most this share of the backward's
# row elements may fall outside it (its f32 TPU path: 0-3 of 6000-9000)
BWD_RTOL, BWD_ATOL, BWD_MAX_OUTSIDE = 1e-3, 1e-4, 1e-3
CHECK_ATOL = 1e-3  # GPU vs CPU frame: f32 GEMM and projection rounding, then compositing
# Fused deform field, kernel vs plain (tests/test_torch_deform_fused.py):
# outputs max |diff| / max |plain| and normwise; the forward's bf16
# activations may round differently where the f32 sums differ in order. The
# backward takes the same saved activations on both sides (no ReLU-mask
# flips), so its gradients keep the JAX package's 1e-2 max budget and 1e-3
# normwise.
DEFORM_OUT_MAX_REL, DEFORM_OUT_NORM_REL = 1e-2, 5e-3
DEFORM_GRAD_MAX_REL, DEFORM_GRAD_NORM_REL = 1e-2, 1e-3
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, bf16 dense
# tensor-core products, HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
SH_C0 = 0.28209479177387814
DEVICE = "cuda"
TRAIN_STEPS = 12
# configs/sim/base.yaml's flow weights; one refine at step 10 (step % 150 = 10 > 0 + 5)
TRAIN_MODEL = dict(
    warm_up=0, background_color="black", flow_loss_weight=0.01, flow_3d_loss_weight=0.1, flow_px_ref=128,
)
TRAIN_DENSIFY = dict(refine_start=10, refine_every=5, reset_alpha_every=30)
# GPU vs CPU train step: the relative L2 difference of each Adam first moment
TRAIN_CHECK_RTOL = 1e-2


def kernel_modules():
    """The port's modules that launch kernels, each with its LAUNCHES and KERNEL_SOURCES."""
    from freegaussian_tpu_torch.ops import mlp_cuda, rasterize_cuda

    return (rasterize_cuda, mlp_cuda)


def launches() -> dict:
    return {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()}


def zero_launches():
    for m in kernel_modules():
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


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


def backward_bound(n: int, channels: int, num_isects: int, num_tiles: int, pixels: int, pairs: int):
    """Least time (ms) the card could take for one backward call, and what
    sets it. Bytes: each input read once (the per-Gaussian rows, one id per
    intersection, the tile offsets, the per-pixel cotangents (C + 1),
    livecnt and t_final), each output written once (one row of 8 + C floats
    per intersection). Operations: `pairs` live (pixel, slot) pairs (the sum
    of livecnt at the 16-px contract tile) times 48 + 4C f32 operations
    each (20 for sigma, alpha and the tests, 11 + 2C for the transmittance,
    the weight and the alpha cotangent, 17 + C for the slot's terms, 6 + C
    adds into the tile's sums)."""
    bytes_ = 4 * (
        n * (7 + channels) + num_isects + num_tiles + 1 + pixels * (channels + 3) + num_isects * (8 + channels)
    )
    ops = pairs * (48 + 4 * channels)
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def deform_bound(n: int, in_ch: int, save: bool, backward: bool):
    """Least time (ms) the card could take for one fused deform-field call,
    and what sets it. Operations: the trunk's products, 2 n 256 (2 in_ch +
    7 x 256) bf16 tensor-core operations (twice that backward: the input
    and the weight gradients), the heads' 2 n 13 x 256 f32 (twice backward),
    over each type's peak. Bytes: x (3 f32) and y or dy (13 f32) per row,
    the bf16 embedding and eight activations (96 + 8 x 256 bf16 per row)
    written by the training forward and read by the backward, dx (3 f32)
    written by the backward, the weights once."""
    trunk = 2.0 * n * 256 * (2 * in_ch + 7 * 256) * (2 if backward else 1)
    heads = 2.0 * n * 13 * 256 * (2 if backward else 1)
    t_ops = (trunk / PEAK_BF16_OPS + heads / PEAK_F32_OPS) * 1e3
    per_row = 4 * (3 + 13) + (2 * (96 + 8 * 256) if (save or backward) else 0) + (4 * 3 if backward else 0)
    weights = 256 * (2 * in_ch + 7 * 256) * (2 + (4 if backward else 0)) + 4 * 13 * 256
    t_bytes = (n * per_row + weights) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _rel_errs(got, want):
    """(max |diff| / max |want|, ||diff|| / ||want||)."""
    got, want = got.double(), want.double()
    diff = got - want
    return float(diff.abs().max() / want.abs().max().clamp(min=1e-30)), float(diff.norm() / want.norm().clamp(min=1e-30))


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
    from concurrent.futures import ThreadPoolExecutor

    from freegaussian_tpu_torch.cuda_build import build

    KERNEL_SOURCES = [name for m in kernel_modules() for name in m.KERNEL_SOURCES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        took = list(pool.map(build, KERNEL_SOURCES))
    for name, seconds in zip(KERNEL_SOURCES, took):
        print(f"build: {name} ({'already built' if seconds is None else f'{seconds:.1f} s'}, sm_90a)")
    print(f"build: all {len(KERNEL_SOURCES)} sources in {time.perf_counter() - t0:.1f} s")


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
    assert model.deform.compute_dtype == torch.bfloat16 and model.deform.fused
    print(
        f"scene: {N_GAUSS} Gaussians, SH degree {model.cfg.sh_degree}, deform 8x256 bf16, "
        f"checkpoint {path.stat().st_size / 2**20:.1f} MiB, written and loaded in {time.perf_counter() - t0:.1f} s"
    )
    return path, model


def phase_kernels(model) -> dict:
    """Each kernel against its plain version on the main path's inputs."""
    import torch

    from freegaussian_tpu_torch.models import fields as fields_mod
    from freegaussian_tpu_torch.ops import rasterize as rasterize_mod
    from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_tiles, rasterize_tiles_plain
    from freegaussian_tpu_torch.ops.tiles import build_intersections

    width, height = SERVE_WH
    pixel_stage = rasterize_mod.rasterize_pixels
    field = fields_mod.deform_field
    captured, field_args = [], []

    def capture(*args, **kwargs):
        captured.append(args)
        return pixel_stage(*args, **kwargs)

    def capture_field(*args):
        field_args.append(args)
        return field(*args)

    rasterize_mod.rasterize_pixels = capture
    fields_mod.deform_field = capture_field
    try:
        model(bench_camera(width, height, DEVICE))
    finally:
        rasterize_mod.rasterize_pixels = pixel_stage
        fields_mod.deform_field = field
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
    bwd_rows = _check_backward(m2d, con, chans, opac, depths, radii, width, height, pairs16)
    return {
        "rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "bwd_rows": bwd_rows, "bwd_max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "deform": _check_deform(*field_args[0]),
    }


def _check_deform(x, t_row, ws, bs, head_w, head_b) -> dict:
    """The fused deform field's kernels against their plain versions on the
    serving call's inputs (the scene's 100k means, its time row at t = 0.5,
    its weights): the forward in training mode (it also writes the saved
    embedding and activations), then the backward from those same saved
    tensors with a seeded N(0, 1) cotangent on the 13 head lanes."""
    import torch

    from freegaussian_tpu_torch.ops import mlp_cuda as mc

    with torch.no_grad():
        x, t_row = x.float().contiguous(), t_row.float().contiguous()
        in_ch = ws[0].shape[1]
        x_lanes = in_ch - t_row.shape[0]
        wpack = mc.pack_trunk([w.detach() for w in ws], in_ch)
        bias = torch.stack([b.detach().float() for b in bs]).contiguous()
        fargs = (x, t_row, wpack, bias, head_w.detach().float().contiguous(), head_b.detach().float().contiguous(), x_lanes, True)
        y, (emb, acts) = mc.deform_field_fwd(*fargs)
        torch.cuda.synchronize()
        yp, (embp, actsp) = mc.deform_field_fwd_plain(*fargs)
        torch.cuda.synchronize()
        n = x.shape[0]
        y_max, y_norm = _rel_errs(y, yp)
        fwd = dict(
            n=n, y_max_rel=y_max, y_norm_rel=y_norm, max_abs_err=float((y - yp).abs().max()),
            emb_mismatch=int((emb != embp).sum()), act_mismatch=int((acts[:, :n] != actsp[:, :n]).sum()),
            ms=cuda_ms(lambda: mc.deform_field_fwd(*fargs), reps=25),
            plain_ms=cuda_ms(lambda: mc.deform_field_fwd_plain(*fargs), reps=5),
        )
        fwd["bound_ms"], fwd["bound_by"] = deform_bound(n, in_ch, True, False)
        print("kernel deform_fwd " + json.dumps(fwd))
        if not (torch.isfinite(y).all() and y_max <= DEFORM_OUT_MAX_REL and y_norm <= DEFORM_OUT_NORM_REL):
            raise AssertionError(f"deform_fwd vs plain: max rel {y_max}, norm rel {y_norm}")

        g = torch.Generator(device="cpu").manual_seed(SEED + 9)
        dy = torch.randn(n, mc.NOUT, generator=g).to(x.device)
        bargs = (x, dy, fargs[2], fargs[4], emb, acts, x_lanes)
        got = mc.deform_field_bwd(*bargs)
        torch.cuda.synchronize()
        want = mc.deform_field_bwd_plain(*bargs)
        torch.cuda.synchronize()
        errs = {name: _rel_errs(a, b) for name, a, b in zip(("dx", "d_emb", "dW", "dbias", "dhead_w", "dhead_b"), got, want)}
        bwd = dict(
            n=n, errs=errs, max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want)),
            ms=cuda_ms(lambda: mc.deform_field_bwd(*bargs), reps=25),
            plain_ms=cuda_ms(lambda: mc.deform_field_bwd_plain(*bargs), reps=5),
        )
        bwd["bound_ms"], bwd["bound_by"] = deform_bound(n, in_ch, True, True)
        print("kernel deform_bwd " + json.dumps(bwd))
        for name, (mx, nm) in errs.items():
            if not (mx <= DEFORM_GRAD_MAX_REL and nm <= DEFORM_GRAD_NORM_REL):
                raise AssertionError(f"deform_bwd vs plain, {name}: max rel {mx}, norm rel {nm}")
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError("deform_bwd: non-finite gradients")
    return {"fwd": fwd, "bwd": bwd}


def _check_backward(m2d, con, chans, opac, depths, radii, width, height, pairs16):
    """The backward kernel against its plain version (autograd through the
    plain compositor) on the serving scene's pixel-stage inputs: C = 3 (RGB)
    and C = 5 (RGB + a seeded 2-channel screen motion, the training path's
    layout), seeded N(0, 1) cotangents, tiles 16 and 32."""
    import torch

    from freegaussian_tpu_torch.ops.rasterize_cuda import (
        rasterize_tiles,
        rasterize_tiles_bwd,
        rasterize_tiles_bwd_plain,
    )
    from freegaussian_tpu_torch.ops.tiles import build_intersections

    n = m2d.shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    flow = (torch.randn(n, 2, generator=g) * 2.0).to(m2d.device)
    rows = []
    for tile in (16, 32):
        isect = build_intersections(m2d, radii, depths, width, height, tile)
        for C in (3, 5):
            col = torch.cat([chans[:, :3], flow], dim=1)[:, :C].contiguous()
            fwd_args = (m2d, con, col, opac, radii, isect.gauss_ids, isect.tile_offsets)
            _, _, livecnt, t_final = rasterize_tiles(*fwd_args, width, height, tile)
            g_color = torch.randn(height, width, C, generator=g).to(m2d.device)
            g_alpha = torch.randn(height, width, generator=g).to(m2d.device)
            kargs = (*fwd_args, livecnt, t_final, g_color, g_alpha, width, height, tile)
            pargs = (*fwd_args, g_color, g_alpha, width, height, tile)
            got = rasterize_tiles_bwd(*kargs)
            torch.cuda.synchronize()
            want = rasterize_tiles_bwd_plain(*pargs)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            outside = int((diff > BWD_ATOL + BWD_RTOL * want.abs()).sum())
            rel = float((diff / want.abs().clamp(min=1e-6))[want.abs() > 1e-3].max())
            k_ms = cuda_ms(lambda: rasterize_tiles_bwd(*kargs), reps=25)
            # the plain backward is autograd over a Python loop (seconds a call): two runs, no warm-up
            p_ms = cuda_ms(lambda: rasterize_tiles_bwd_plain(*pargs), reps=2, warmup=0)
            bound_ms, bound_by = backward_bound(n, C, isect.num_isects, isect.num_tiles, width * height, pairs16)
            row = dict(
                tile=tile, C=C, num_isects=isect.num_isects, elements=got.numel(), max_abs_err=float(diff.max()),
                max_rel_err_where_above_1e3=rel, outside_budget=outside, zero_rows=int((got == 0).all(1).sum()),
                ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
            )
            print("kernel rasterize_bwd " + json.dumps(row))
            if not torch.isfinite(got).all():
                raise AssertionError(f"backward kernel at tile {tile}, C={C}: non-finite rows")
            if outside > BWD_MAX_OUTSIDE * got.numel():
                raise AssertionError(
                    f"backward kernel vs plain at tile {tile}, C={C}: {outside} of {got.numel()} elements "
                    f"outside rtol {BWD_RTOL} / atol {BWD_ATOL}"
                )
            rows.append(row)
    return rows


def _serve(model, width: int, height: int, views, label: str):
    """Start a viewer over `model`, GET /render for each view, check every
    answer, shut it down. The launch counts are zeroed just before the
    requests and read just after. Returns (request latencies in ms, launches)."""
    from freegaussian_tpu_torch.viewer.png import decode_png
    from freegaussian_tpu_torch.viewer.server import ViewerServer, model_render_fn

    server = ViewerServer(model_render_fn(model), width=width, height=height, port=0, host="127.0.0.1", device=DEVICE)
    server.start_background()
    latencies = []
    try:
        assert http_get(server.port, "/")[0] == 200
        status, _, body = http_get(server.port, "/info")
        assert status == 200 and json.loads(body) == {"num_attributes": 0}
        zero_launches()
        for th, ph, r, t in views:
            before = sum(launches().values())
            t0 = time.perf_counter()
            status, ctype, body = http_get(server.port, f"/render?th={th}&ph={ph}&r={r}&t={t}")
            ms = (time.perf_counter() - t0) * 1e3
            assert status == 200 and ctype == "image/png", (status, ctype)
            img = decode_png(body)
            assert img.shape == (height, width, 3), img.shape
            assert img.std() > 1.0 and len(np.unique(img.reshape(-1, 3), axis=0)) > 100, "constant frame"
            launched = sum(launches().values()) - before
            assert launched == 2, f"{launched} kernel launches for one request, want the deform field's and the compositor's"
            latencies.append(ms)
            print(f"serve {label} {width}x{height} th={th} ph={ph} r={r} t={t}: 200 image/png {len(body)} B in {ms:.1f} ms")
        counts = launches()
    finally:
        server.shutdown()
    # serving runs the deform field and the compositor once per request, never a backward
    want = {name: len(views) if name in ("rasterize_fwd", "deform_fwd") else 0 for name in counts}
    if counts != want:
        raise AssertionError(f"launches {counts} in {len(views)} requests on the {label} path, want {want}")
    return latencies, counts


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


def build_train_case(model, width: int, height: int, device=None, flow_3d: bool = True):
    """The training phase's inputs, from the loaded bench scene: a trainable
    copy of its parameters and deform field (bf16 trunk), the training
    config (tile 32, warm-up 0, black background, configs/sim/base.yaml's
    flow weights), the bench camera at t = 0.5 and its paired camera at
    t = 0.4, and seeded synthetic targets: the image is the scene rendered
    with its SH DC colors shifted by N(0, 0.3) noise, depth0 the scene's
    expected depth from the paired camera, the flow a constant (0.8, -0.5) px
    motion plus N(0, 0.3) noise. Returns (state, step_fn, camera, camera0, batch)."""
    import copy
    import dataclasses

    import torch

    from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
    from freegaussian_tpu_torch.engine.train_step import create_train_state, make_train_step
    from freegaussian_tpu_torch.models.densify import DensifyConfig
    from freegaussian_tpu_torch.models.splat_model import SplatConfig, forward

    device = device or DEVICE
    cfg = dataclasses.replace(SplatConfig(**TRAIN_MODEL), deform_bf16=model.cfg.deform_bf16)
    if not flow_3d:
        cfg = dataclasses.replace(cfg, flow_3d_loss_weight=0.0)
    params = {k: v.detach().to(device).clone() for k, v in model.params.items()}
    alive = model.alive.to(device).clone()
    deform = copy.deepcopy(model.deform).to(device).requires_grad_(True)
    camera = bench_camera(width, height, device, 0.5)
    camera0 = bench_camera(width, height, device, 0.4)
    g = torch.Generator(device="cpu").manual_seed(SEED + 11)
    shifted = dict(params, features_dc=params["features_dc"] + 0.3 * torch.randn(params["features_dc"].shape, generator=g).to(device))
    image = forward(cfg, shifted, alive, camera, deform=deform, sh_degree_now=3, warmed_up=True, render_mode="RGB")["rgb"]
    depth0 = forward(cfg, params, alive, camera0, deform=deform, sh_degree_now=3, warmed_up=True, render_mode="RGB+ED")["depth"]
    flow = torch.tensor([0.8, -0.5]) + 0.3 * torch.randn(height, width, 2, generator=g)
    batch = {"image": image, "depth0": depth0, "flow": flow.to(device)}
    optimizers = make_optimizers(OptimizersConfig())
    state = create_train_state(params, alive, deform, optimizers, generator=torch.Generator(device=device).manual_seed(SEED))
    step_fn = make_train_step(cfg, DensifyConfig(**TRAIN_DENSIFY), optimizers, num_train_data=0)
    return state, step_fn, camera, camera0, batch


def phase_train(model) -> dict:
    """The training path: TRAIN_STEPS steps at the bench operating point
    (640x480, tile 32); the launch counts are zeroed just before the steps
    and read just after."""
    import torch

    from freegaussian_tpu_torch.models.splat_model import SplatConfig

    width, height = SERVE_WH
    state, step_fn, camera, camera0, batch = build_train_case(model, width, height)
    assert camera.width == width and state.params["means"].shape[0] == N_GAUSS
    n_isects, losses, step_ms, refines = [], [], [], []
    torch.cuda.synchronize()
    zero_launches()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, camera, batch, 3, camera0=camera0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(m[k]) for k in ("loss", "main_loss", "l1", "ssim", "psnr", "flow_2d", "flow_3d")}
        if not bool(m["params_finite"]) or not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: non-finite state or loss {vals}")
        losses.append(vals["loss"])
        n_isects.append(int(m["num_isects"]))
        line = {k: round(v, 6) for k, v in vals.items()}
        line.update(gaussians=int(m["gaussian_count"]), num_isects=n_isects[-1], ms=round(step_ms[-1], 2))
        if "refine" in m:
            refines.append((i, {k: int(v) for k, v in m["refine"].items()}))
            line["refine"] = refines[-1][1]
        print(f"train step {i}: " + json.dumps(line))
    counts = launches()
    steady = statistics.median(step_ms[2:])
    pps = width * height / (steady / 1e3)
    tile = SplatConfig(**TRAIN_MODEL).tile_size
    print(
        f"train {width}x{height} tile {tile}: launches {json.dumps(counts)} in {TRAIN_STEPS} steps; "
        f"median step {steady:.2f} ms over the last {TRAIN_STEPS - 2} (first {step_ms[0]:.1f} ms); "
        f"train_step_pixels_per_sec {pps:.0f}"
    )
    # the deform field runs at the frame's time and at the paired frame's
    want = {name: TRAIN_STEPS * (2 if name.startswith("deform") else 1) for name in counts}
    if counts != want:
        raise AssertionError(f"launches {counts} in {TRAIN_STEPS} train steps, want {want}")
    if len(refines) != 1:
        raise AssertionError(f"{len(refines)} refines in {TRAIN_STEPS} steps, want 1")
    at, refined = refines[0]
    print(f"train refine at step {at}: split {refined['num_split']}, dup {refined['num_dup']}, "
          f"cull {refined['num_culled']}, alive after {refined['num_alive']}")
    # the refine runs at the end of step `at`, after that step's loss: the
    # last loss before the refine's culls is losses[at]
    if not losses[at] < losses[0]:
        raise AssertionError(f"loss did not fall before the refine: step 0 {losses[0]}, step {at} {losses[at]}")
    print(f"train loss step 0 {losses[0]:.6f} -> step {at} {losses[at]:.6f} (the last before the refine)")
    return {"launches": counts, "tile": tile, "median_step_ms": steady, "pixels_per_sec": pps}


def phase_train_check(model):
    """One training step on the GPU (the compositor and its backward)
    against the same step on the CPU (their plain versions), on the first
    4000 Gaussians at 160x120 with the deform field in f32 and the same
    random draws: the loss to rtol 1e-4, and each Adam first moment (the
    step's gradient, scaled) by its relative L2 difference, at most
    TRAIN_CHECK_RTOL in every group. The flow-3D loss is off here: its L1
    against a detached target gives every Gaussian a gradient of +-1 per
    axis, whose sign flips wherever a deformed mean sits within f32
    rounding of its target, so the two devices may disagree by whole
    units there; the 2D flow loss stays on."""
    import dataclasses

    import torch

    from freegaussian_tpu_torch.models.splat_model import SplatModel

    n = min(4000, N_GAUSS)
    small = SplatModel(dataclasses.replace(model.cfg, deform_bf16=False), n, device="cpu")
    with torch.no_grad():
        for k, v in model.params.items():
            small.gauss_params[k].copy_(v[:n].cpu())
        small.alive.copy_(model.alive[:n].cpu())
        small.deform.load_state_dict({k: v.float().cpu() for k, v in model.deform.state_dict().items()})
    g = torch.Generator().manual_seed(SEED + 13)
    draws = {"background": torch.rand(3, generator=g), "split_eps": (torch.randn(n, 3, generator=g), torch.randn(n, 3, generator=g))}
    out = {}
    for dev in (DEVICE, "cpu"):
        state, step_fn, camera, camera0, batch = build_train_case(small, 160, 120, device=dev, flow_3d=False)
        state, m = step_fn(state, camera, batch, 3, camera0=camera0, draws=draws)
        out[dev] = (float(m["loss"]), {g: {k: v.cpu() for k, v in st.mu.items()} for g, st in state.opt_states.items()})
    (lg, mug), (lc, muc) = out[DEVICE], out["cpu"]
    errs = {}
    for g, moments in muc.items():
        for k, want in moments.items():
            errs[f"{g}.{k}"] = float((mug[g][k] - want).norm() / want.norm().clamp(min=1e-30))
    worst = {g: max(v for k, v in errs.items() if k.startswith(g + ".")) for g in muc}
    print(f"check train step 160x120 GPU vs CPU: loss {lg:.7f} vs {lc:.7f}; Adam first moment, relative "
          f"L2 difference, worst tensor of each group: {json.dumps({g: float(f'{v:.3g}') for g, v in worst.items()})}")
    if not abs(lg - lc) <= 1e-4 * abs(lc):
        raise AssertionError("GPU train step loss differs from the CPU train step's")
    for g, v in worst.items():
        if v > TRAIN_CHECK_RTOL:
            raise AssertionError(f"GPU train step differs from the CPU train step in group {g}: {v}")


def main():
    preflight()
    import torch

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt, model = phase_scene(Path(tmp))
        kern = phase_kernels(model)
        serve = phase_serve(model, ckpt)
        phase_check(ckpt)
        train = phase_train(model)
        phase_train_check(model)
    main_row = next(r for r in kern["rows"] if r["tile"] == model.cfg.tile_size and r["C"] == 4)
    bwd_row = next(r for r in kern["bwd_rows"] if r["tile"] == train["tile"] and r["C"] == 5)
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
    bwd_record = {
        "name": "rasterize_bwd",
        "route": "cuda",
        "source": "freegaussian_tpu_torch/csrc/rasterize_bwd.cu",
        "replaces": "freegaussian_tpu/ops/rasterize_pallas.py:857",
        "launches": train["launches"]["rasterize_bwd"],
        "max_abs_err": kern["bwd_max_abs_err"],
        "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": None,
    }
    records = [record, bwd_record]
    for name, line, mode in (("deform_fwd", 537, "fwd"), ("deform_bwd", 555, "bwd")):
        row = kern["deform"][mode]
        records.append({
            "name": name,
            "route": "cuda",
            "source": "freegaussian_tpu_torch/csrc/deform_field.cu",
            "replaces": f"freegaussian_tpu/ops/mlp_pallas.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    assert [r["name"] for r in records] == list(launches())
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
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
