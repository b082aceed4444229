"""Smoke run of the PyTorch port (`freegaussian_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's stage-1 serving path (reference checkpoint ->
`forward(train=False)` -> HTTP viewer), its stage-1 training step
(`make_train_step`: forward, loss, backward, Adam, densification), its
stage-2 control path in the `deform_impl="pallas"` configuration (the
slider viewer over a stage-2 checkpoint, and `make_control_train_step`),
and the `train` and `train-control` CLI verbs over a dataset on disk, with
every kernel built from this checkout. Phases, printed as each ends:

  1. device   the card's name and power limit, as nvidia-smi gives them
  2. build    nvcc builds every kernel source, one process per source, all
              started together
  3. scene    a seeded synthetic scene at the bench.py operating point
              (100k Gaussians, SH degree 3, scales log(0.015), the 50/30/20
              opacity mixture, a full 8x256 deform field with heads x 0.01),
              written as a reference checkpoint and loaded back
  4. kernels  each kernel against its plain PyTorch version on the inputs
              the main paths give it (640x480; tiles 16 and 32): the
              compositor at C = 3 and 4, its backward by both walks at C
              = 3 and 5 with seeded cotangents (the forward walk also on a
              sparse frame, every tenth Gaussian), the fused deform field's forward (100k
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
  8. scene2   the stage-2 scene: a seeded control field (heads x 0.01) and a
              seeded (N, 3) cluster mask over ~30% of the Gaussians in three
              overlapping spatial regions, written as a reference checkpoint
              with control.* keys and a gaussian_mask_NxM.npy, loaded back
              with deform_impl "pallas"
  9. kernels2 the field trunk's kernel pair against its plain versions on
              the stage-2 inputs, in both source modes (the control trunk:
              100k means and their control values; the deform trunk: the
              means and the timenet row): max |diff|, the share of elements
              outside the budget, kernel ms (training and serving modes),
              plain ms and the bound
 10. serve2   the stage-2 serving path: the slider viewer answers GET
              /render with non-zero sliders at 640x480 (tile 32); latency,
              and launches zeroed before the requests and read after (one
              control-trunk forward and one compositor per request)
 11. train2   the stage-2 training path: 12 steps of
              `make_control_train_step` against a seeded target; the loss of
              every step, the median step time and train_step_pixels_per_sec,
              launches per step (three field-trunk forwards: the deform
              trunk at the init time and at the frame's, the control trunk;
              one field-trunk backward; one compositor and its backward)
 12. check2   a stage-2 frame and one stage-2 step at 160x120 on the GPU
              against the CPU, with the fields in f32 and, in six seeded
              cases, on the field-trunk kernels; the stage-1 checks'
              budgets, and on the kernels a looser one for the control
              field's tensors
 13. dataset  a synthetic 640x480 dataset in parse_synthetic's layout: 8
              frames rendered from the bench scene at their frame times,
              seeded depth, interflow and mask npys
 14. train    the `train` verb in process (`cli.main`) on
     verb     configs/sim/base.yaml with overrides (warm-up 0, no
              downscale, refine every 10 steps from step 10): 30 steps from
              1e5 random Gaussians, one eval of every frame, one save; the
              loss of every step is finite, metrics.jsonl is written, the
              checkpoint reloads equal; step ms and steps/s against phase
              7's bare step; launches of the compositor pair and the deform
              kernels
 15. train-   the `train-control` verb over that checkpoint with a seeded
     control  mask and deform_impl "pallas": 10 steps, field-trunk launches
 16. fwd walk 3 more steps of the train verb's trainer with
              `rasterize_cuda.BWD_WALK = "fwd"`: the forward-walk backward
              launches, the reverse walk does not (phase 4 holds that
              kernel against its plain version and row 2's kernel)
 17. trunk    the deform field with per-point times at N = 1e5 (its trunk
              on the precomputed embedding) forward and backward, launches;
              the kernel pair against its plain versions, ms, bound

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
VIEWS = [(0.0, 0.0, 4.0, 0.0), (0.8, 0.3, 4.0, 0.25), (-1.2, -0.4, 3.5, 0.5), (2.5, 0.9, 5.0, 0.75), (3.1, -1.0, 4.5, 1.0)]
# Stage 2: the control field's kernels run under deform_impl "pallas"; M = 3
# attributes; the init camera's time (the control state is the deform
# field's displacement from it); the slider values of the served requests
# (the viewer scales them by 0.1)
STAGE2_IMPL = "pallas"
INIT_TIME = 0.0
SLIDERS = [np.array(v, np.float32).reshape(3, 3) for v in (
    [4, 0, 0, 0, 3, 0, 0, 0, -3], [-3, 2, 1, 1, -2, 3, 2, 2, 2], [0, -4, 2, 3, 0, -1, -2, 1, 0],
    [2, 2, -2, -3, 1, 0, 4, -1, 1], [-1, 0, 3, 2, -3, -2, 0, 3, -4],
)]
# GPU vs CPU on the field kernels (stage 2, "pallas") against their plain
# versions, one case per seed (a Gaussian subset, a camera, a target): the
# stage-1 checks' budgets (frame CHECK_ATOL, loss rtol 1e-4, every tensor of
# the Adam first moments TRAIN_CHECK_RTOL) but for the control field's
# tensors, each held within TRAIN_CHECK_KERNEL_CONTROL_RTOL: the kernels'
# bf16 activations round differently where an f32 sum straddles a rounding
# boundary (0.09% of them at N = 1e5), and a ReLU mask flipped there moves
# single elements of the control field's small gradients. Twice the worst
# reading over these six seeds on an H100 (0.0302; PERF.md); the kernel
# pair is held tighter from the same saved activations in phase kernels2.
CHECK2_SEEDS = 6
TRAIN_CHECK_KERNEL_CONTROL_RTOL = 0.06
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


def synthetic_field_state(field, head_names, seed: int, head_scale: float = 0.01) -> dict:
    """torch nn.Linear's default init, U(+-1/sqrt(fan_in)), for every layer
    of `field`, from a numpy seed; the output heads (`head_names`) scaled by
    `head_scale` (trained-like small deltas, as bench.py does)."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in field.state_dict().items():
        layer = name.rsplit(".", 1)[0]
        fan_in = field.get_submodule(layer).weight.shape[1]
        bound = 1.0 / np.sqrt(fan_in)
        a = rng.uniform(-bound, bound, size=tuple(p.shape))
        if layer in head_names:
            a = a * head_scale
        state[name] = a.astype(np.float32)
    return state


def synthetic_deform_state(deform, seed: int = SEED + 1, head_scale: float = 0.01) -> dict:
    from freegaussian_tpu_torch.models.fields import HEAD_NAMES

    return synthetic_field_state(deform, HEAD_NAMES, seed, head_scale)


def synthetic_control_state(control, seed: int = SEED + 2, head_scale: float = 0.01) -> dict:
    """The control field's seeded weights, heads x 0.01: at the reference's
    head init they would move linear scales by up to 1/16, some 4 times the
    scene's 0.015, and turn some negative."""
    from freegaussian_tpu_torch.models.fields import CONTROL_HEAD_NAMES

    return synthetic_field_state(control, CONTROL_HEAD_NAMES, seed, head_scale)


def synthetic_mask(means: np.ndarray, seed: int = SEED + 3) -> np.ndarray:
    """A seeded (N, 3) cluster mask in spatial regions: three balls around
    seeded points of the cloud, each holding ~12% of the Gaussians, the first
    two overlapping; ~30% of the Gaussians in at least one."""
    rng = np.random.default_rng(seed)
    c0 = means[rng.integers(len(means))] * 0.5
    centers = [c0, c0 + rng.normal(scale=0.6, size=3), means[rng.integers(len(means))] * 0.5]
    mask = np.zeros((len(means), len(centers)), bool)
    for j, c in enumerate(centers):
        d = np.linalg.norm(means - c, axis=1)
        mask[:, j] = d <= np.quantile(d, 0.12)
    return mask


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


def host_probe_ms() -> float:
    """The host's speed, for reading the request latencies (host clocks):
    the median ms of 5 PNG encodes of one seeded 640x480 frame, the host
    work that takes most of a request."""
    from freegaussian_tpu_torch.viewer.png import encode_png

    rng = np.random.default_rng(SEED)
    ramp = np.linspace(0, 200, 640, dtype=np.float32)[None, :, None]
    img = (ramp + rng.integers(0, 56, size=(480, 640, 3))).astype(np.uint8)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        encode_png(img)
        times.append((time.perf_counter() - t0) * 1e3)
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


def field_bound(n: int, in_ch: int, save: bool, backward: bool, heads: bool, sources: int = 1):
    """Least time (ms) the card could take for one call of the field-MLP
    kernels, and what sets it. Operations: the trunk's products, 2 n 256
    (2 in_ch + 7 x 256) bf16 tensor-core operations (twice that backward:
    the input and the weight gradients), with `heads` the heads' 2 n 13 x
    256 f32 (twice backward), over each type's peak. Bytes: per row the
    sources (3 S f32) and the output (13 f32 heads, or the trunk's 256
    bf16, which in training is the last saved activation and counts once
    there) or, backward, its cotangent (13 or 256 f32) and dx (3 S f32);
    the bf16 embedding and eight activations ((128 + 8 x 256) bf16) written
    by the training forward and read by the backward; the weights once."""
    trunk = 2.0 * n * 256 * (2 * in_ch + 7 * 256) * (2 if backward else 1)
    head_ops = 2.0 * n * 13 * 256 * (2 if backward else 1) if heads else 0.0
    t_ops = (trunk / PEAK_BF16_OPS + head_ops / PEAK_F32_OPS) * 1e3
    if backward:
        io = 4 * 3 * sources * 2 + (4 * 13 if heads else 4 * 256)
    else:
        io = 4 * 3 * sources + (4 * 13 if heads else (0 if save else 2 * 256))
    per_row = io + (2 * (128 + 8 * 256) if (save or backward) else 0)
    weights = 256 * (2 * in_ch + 7 * 256) * (2 + (4 if backward else 0)) + (4 * 13 * 256 if heads else 0)
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
    assert model.deform.compute_dtype == torch.bfloat16 and model.deform.impl == "fused"
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
        "bwd_rows": bwd_rows,
        "bwd_max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["walk"] == "rev"),
        "bwd_fwd_max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["walk"] == "fwd"),
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
        fwd["bound_ms"], fwd["bound_by"] = field_bound(n, in_ch, True, False, True)
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
        bwd["bound_ms"], bwd["bound_by"] = field_bound(n, in_ch, True, True, True)
        print("kernel deform_bwd " + json.dumps(bwd))
        for name, (mx, nm) in errs.items():
            if not (mx <= DEFORM_GRAD_MAX_REL and nm <= DEFORM_GRAD_NORM_REL):
                raise AssertionError(f"deform_bwd vs plain, {name}: max rel {mx}, norm rel {nm}")
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError("deform_bwd: non-finite gradients")
    return {"fwd": fwd, "bwd": bwd}


def _check_backward(m2d, con, chans, opac, depths, radii, width, height, pairs16):
    """The backward kernels against their plain version (autograd through
    the plain compositor, the same function for both walks) on the serving
    scene's pixel-stage inputs: C = 3 (RGB) and C = 5 (RGB + a seeded
    2-channel screen motion, the training path's layout), seeded N(0, 1)
    cotangents, tiles 16 and 32. The reverse walk (row 2) is held to the
    JAX package's gradient budget. The forward walk (row 3) is held to the
    same budget against the plain version and against row 2's kernel, on
    this dense frame (where its suffix identity cancels most) and on a
    sparse frame (every tenth Gaussian), with its largest relative error
    reported; its rows
    that are exactly zero (slots past every pixel's termination) must be
    row 2's, which reads the forward's own live counts."""
    import torch

    from freegaussian_tpu_torch.ops.rasterize_cuda import (
        rasterize_tiles,
        rasterize_tiles_bwd,
        rasterize_tiles_bwd_fwd,
        rasterize_tiles_bwd_plain,
    )
    from freegaussian_tpu_torch.ops.tiles import build_intersections

    def budget(got, want):
        diff = (got - want).abs()
        outside = int((diff > BWD_ATOL + BWD_RTOL * want.abs()).sum())
        above = want.abs() > 1e-3
        rel = float((diff / want.abs().clamp(min=1e-6))[above].max()) if bool(above.any()) else 0.0
        return diff, outside, rel

    n = m2d.shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    flow = (torch.randn(n, 2, generator=g) * 2.0).to(m2d.device)
    rows = []
    frames = [("bench", torch.arange(n, device=m2d.device), (16, 32), (3, 5))]
    frames.append(("sparse", torch.arange(0, n, 10, device=m2d.device), (16, 32), (5,)))
    for frame, keep, tiles, channels in frames:
        fm2d, fcon, fchans, fopac, fdepths, fradii, fflow = (a[keep].contiguous() for a in (m2d, con, chans, opac, depths, radii, flow))
        for tile in tiles:
            isect = build_intersections(fm2d, fradii, fdepths, width, height, tile)
            for C in channels:
                col = torch.cat([fchans[:, :3], fflow], dim=1)[:, :C].contiguous()
                fwd_args = (fm2d, fcon, col, fopac, fradii, isect.gauss_ids, isect.tile_offsets)
                color, alpha, livecnt, t_final = rasterize_tiles(*fwd_args, width, height, tile)
                g_color = torch.randn(height, width, C, generator=g).to(m2d.device)
                g_alpha = torch.randn(height, width, generator=g).to(m2d.device)
                r_total = ((color * g_color).sum(-1) + alpha * g_alpha).contiguous()
                kargs = (*fwd_args, livecnt, t_final, g_color, g_alpha, width, height, tile)
                fargs = (*fwd_args, livecnt, r_total, g_color, g_alpha, width, height, tile)
                pargs = (*fwd_args, g_color, g_alpha, width, height, tile)
                got = rasterize_tiles_bwd(*kargs)
                got_f = rasterize_tiles_bwd_fwd(*fargs)
                torch.cuda.synchronize()
                want = rasterize_tiles_bwd_plain(*pargs)
                torch.cuda.synchronize()
                # the plain backward is autograd over a Python loop (seconds a call): two runs, no warm-up
                p_ms = cuda_ms(lambda: rasterize_tiles_bwd_plain(*pargs), reps=2, warmup=0) if frame == "bench" else None
                bound_ms, bound_by = backward_bound(fm2d.shape[0], C, isect.num_isects, isect.num_tiles, width * height, pairs16) if frame == "bench" else (None, None)
                for walk, rows_k, args, fn in (("rev", got, kargs, rasterize_tiles_bwd), ("fwd", got_f, fargs, rasterize_tiles_bwd_fwd)):
                    if frame == "sparse" and walk == "rev":
                        continue
                    diff, outside, rel = budget(rows_k, want)
                    row = dict(
                        frame=frame, walk=walk, tile=tile, C=C, num_isects=isect.num_isects, elements=rows_k.numel(),
                        max_abs_err=float(diff.max()), max_rel_err_where_above_1e3=rel, outside_budget=outside,
                        outside_share=outside / max(rows_k.numel(), 1), zero_rows=int((rows_k == 0).all(1).sum()),
                        ms=cuda_ms(lambda: fn(*args), reps=25), plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                    )
                    if walk == "fwd":
                        row["max_abs_diff_to_rev_kernel"] = float((rows_k - got).abs().max())
                        row["outside_budget_to_rev_kernel"] = budget(rows_k, got)[1]
                        row["zero_rows_differ_from_rev_kernel"] = int(((rows_k == 0).all(1) != (got == 0).all(1)).sum())
                    name = "rasterize_bwd" if walk == "rev" else "rasterize_bwd_fwd"
                    print(f"kernel {name} " + json.dumps(row))
                    if not torch.isfinite(rows_k).all():
                        raise AssertionError(f"{name} at tile {tile}, C={C} ({frame}): non-finite rows")
                    held = [("plain", outside)]
                    if walk == "fwd":
                        held.append(("row 2's kernel", row["outside_budget_to_rev_kernel"]))
                        if row["zero_rows_differ_from_rev_kernel"]:
                            raise AssertionError(
                                f"{name} at tile {tile}, C={C} ({frame}): {row['zero_rows_differ_from_rev_kernel']} rows "
                                "are zero in one walk and not in the other (the forward walk's liveness replay)"
                            )
                    for against, out in held:
                        if out > BWD_MAX_OUTSIDE * rows_k.numel():
                            raise AssertionError(
                                f"{name} vs {against} at tile {tile}, C={C} ({frame}): {out} of {rows_k.numel()} "
                                f"elements outside rtol {BWD_RTOL} / atol {BWD_ATOL}"
                            )
                    rows.append(row)
    return rows


def _serve(render_fn, width: int, height: int, views, label: str, per_request: dict, num_attributes: int = 0,
           atrbs=None):
    """Start a viewer over `render_fn`, GET /render for each view (with the
    attribute sliders `atrbs[i]` when given), check every answer, shut it
    down. The launch counts are zeroed just before the requests and read
    just after; each request must launch `per_request` (kernel name ->
    count) and nothing else. With sliders, one more request (after the
    counts are read) at the first view with the sliders at zero must give
    another frame. Returns (request latencies in ms, launches)."""
    from freegaussian_tpu_torch.viewer.png import decode_png
    from freegaussian_tpu_torch.viewer.server import ViewerServer

    def query(i, atrb):
        th, ph, r, t = views[i]
        q = f"/render?th={th}&ph={ph}&r={r}&t={t}"
        return q if atrb is None else q + "&atrb=" + ",".join(f"{v:g}" for v in np.ravel(atrb))

    def get_frame(path):
        """(frame, PNG bytes, the request's ms: to its last byte, before the decode)."""
        t0 = time.perf_counter()
        status, ctype, body = http_get(server.port, path)
        ms = (time.perf_counter() - t0) * 1e3
        assert status == 200 and ctype == "image/png", (status, ctype)
        img = decode_png(body)
        assert img.shape == (height, width, 3), img.shape
        assert img.std() > 1.0 and len(np.unique(img.reshape(-1, 3), axis=0)) > 100, "constant frame"
        return img, len(body), ms

    server = ViewerServer(
        render_fn, num_attributes=num_attributes, width=width, height=height, port=0, host="127.0.0.1", device=DEVICE
    )
    server.start_background()
    latencies, frames = [], []
    try:
        assert http_get(server.port, "/")[0] == 200
        status, _, body = http_get(server.port, "/info")
        assert status == 200 and json.loads(body) == {"num_attributes": num_attributes}
        zero_launches()
        for i in range(len(views)):
            before = sum(launches().values())
            img, size, ms = get_frame(query(i, None if atrbs is None else atrbs[i]))
            launched = sum(launches().values()) - before
            assert launched == sum(per_request.values()), f"{launched} kernel launches for one request, want {per_request}"
            latencies.append(ms)
            frames.append(img)
            print(f"serve {label} {width}x{height} {query(i, None if atrbs is None else atrbs[i])}: 200 image/png {size} B in {ms:.1f} ms")
        counts = launches()
        if atrbs is not None:
            still = get_frame(query(0, np.zeros_like(atrbs[0])))[0]
            changed = float(np.mean(np.any(still != frames[0], axis=-1)))
            print(f"serve {label}: the sliders change {changed:.1%} of the first view's pixels")
            assert changed > 0.001, "the sliders do not move the render"
    finally:
        server.shutdown()
    print(f"serve {label}: host probe {host_probe_ms():.2f} ms")
    want = {name: len(views) * per_request.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"launches {counts} in {len(views)} requests on the {label} path, want {want}")
    return latencies, counts


def phase_serve(model, ckpt: Path) -> dict:
    """The main path (640x480, tile 32 as SplatConfig serves), then the
    native frame size at tile 16 and 32; each path's launches are its own."""
    import dataclasses

    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint

    from freegaussian_tpu_torch.viewer.server import model_render_fn

    model16 = load_reference_checkpoint(ckpt, cfg=dataclasses.replace(model.cfg, tile_size=16), device=DEVICE)
    (w, h), (nw, nh) = SERVE_WH, NATIVE_WH
    # serving runs the deform field and the compositor once per request, never a backward
    per = {"rasterize_fwd": 1, "deform_fwd": 1}
    paths = {
        "main": (f"{w}x{h} tile 32", _serve(model_render_fn(model), w, h, VIEWS, "main", per)),
        # 81 x 61 = 4941 tiles of 16 px at 1296x968: the exact two-key sort
        "native16": (f"{nw}x{nh} tile 16", _serve(model_render_fn(model16), nw, nh, VIEWS[:3], "native16", per)),
        "native32": (f"{nw}x{nh} tile 32", _serve(model_render_fn(model), nw, nh, VIEWS[:3], "native32", per)),
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
    per_step = {"rasterize_fwd": 1, "rasterize_bwd": 1, "deform_fwd": 2, "deform_bwd": 2}
    want = {name: TRAIN_STEPS * per_step.get(name, 0) for name in counts}
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


# ---------------------------------------------------------------------------
# stage 2: the control path
# ---------------------------------------------------------------------------


def stage2_cfg(cfg):
    import dataclasses

    return dataclasses.replace(cfg, deform_impl=STAGE2_IMPL)


def phase_scene2(tmp: Path, model):
    """The stage-2 scene: the bench scene with a seeded control field (heads
    x 0.01) and a seeded (N, 3) cluster mask, written as a reference
    checkpoint with control.* keys and a gaussian_mask_NxM.npy, and loaded
    back with `load_control_checkpoint` under deform_impl "pallas"."""
    import torch

    from freegaussian_tpu_torch.models.splat_model import make_control_field
    from freegaussian_tpu_torch.models.torch_compat import export_reference_checkpoint, load_control_checkpoint
    from freegaussian_tpu_torch.preprocess.clustering import save_gaussian_mask

    t0 = time.perf_counter()
    control = make_control_field(stage2_cfg(model.cfg))
    want_control = synthetic_control_state(control)
    control.load_state_dict({k: torch.from_numpy(v) for k, v in want_control.items()}, strict=True)
    mask = synthetic_mask(model.params["means"].cpu().numpy())
    path = export_reference_checkpoint(
        tmp / "stage2" / "step-000045000.ckpt", model.params, model.alive, deform=model.deform, control=control, step=45000
    )
    mask_path = tmp / "stage2" / f"gaussian_mask_{N_GAUSS}x{mask.shape[1]}.npy"
    save_gaussian_mask(mask_path, torch.from_numpy(mask), model.alive.cpu())
    model2 = load_control_checkpoint(path, mask_path, cfg=stage2_cfg(model.cfg), device=DEVICE)
    assert np.array_equal(model2.gaussian_mask.cpu().numpy(), mask) and model2.step == 45000
    for k, v in want_control.items():
        assert np.array_equal(model2.control.state_dict()[k].cpu().numpy(), v), k
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    assert model2.control.impl == "pallas" and model2.deform.impl == "pallas"
    covered = mask.any(1)
    print(
        f"scene2: control field 8x256 f32 (heads x 0.01) on the field-trunk kernels, mask {mask.shape} with "
        f"{covered.mean():.1%} of the Gaussians in a cluster (per attribute "
        f"{', '.join(f'{c:.1%}' for c in mask.mean(0))}; {(mask.sum(1) > 1).mean():.1%} in two or more), "
        f"written and loaded in {time.perf_counter() - t0:.1f} s"
    )
    return path, mask_path, model2


def phase_kernels2(model2) -> dict:
    """The field-trunk kernels against their plain versions on the stage-2
    path's inputs: the control trunk (two sources: the 100k means and their
    blended control values at the first slider setting) and the deform
    trunk (one source and the timenet row at t = 0.5)."""
    import torch

    from freegaussian_tpu_torch.models import fields as fields_mod

    trunk = fields_mod.field_trunk
    calls = []

    def capture(*args):
        calls.append(args)
        return trunk(*args)

    fields_mod.field_trunk = capture
    try:
        with torch.no_grad():
            model2(bench_camera(*SERVE_WH, DEVICE), 0.1 * SLIDERS[0])
            model2.deform(model2.params["means"], torch.full((1, 1), 0.5, device=DEVICE))
    finally:
        fields_mod.field_trunk = trunk
    assert len(calls) == 2 and calls[0][1] is not None and calls[1][2] is not None
    return {"control": _check_field("control", *calls[0]), "deform": _check_field("deform", *calls[1])}


def _check_field(mode, x, value, t_row, ws, bs) -> dict:
    """`field_trunk_fwd` (training mode, which also writes the saved
    embedding and activations; and serving mode) and `field_trunk_bwd` (from
    those saved tensors, a seeded N(0, 1) cotangent rounded to bf16 as
    autograd hands it over) against their plain versions."""
    import torch

    from freegaussian_tpu_torch.ops import mlp_cuda as mc

    with torch.no_grad():
        srcs = [x] if value is None else [x, value]
        xsrc = torch.cat([a.float() for a in srcs], dim=1).contiguous()
        sources = len(srcs)
        t_row = (t_row if t_row is not None else x.new_zeros(0)).float().contiguous()
        in_ch = ws[0].shape[1]
        x_lanes = (in_ch - t_row.shape[0]) // sources
        wpack = mc.pack_trunk([w.detach() for w in ws], in_ch)
        bias = torch.stack([b.detach().float() for b in bs]).contiguous()
        fargs = (xsrc, t_row, wpack, bias, sources, x_lanes)
        n = xsrc.shape[0]
        h, (emb, acts) = mc.field_trunk_fwd(*fargs, True)
        torch.cuda.synchronize()
        hp, (embp, actsp) = mc.field_trunk_fwd_plain(*fargs, True)
        torch.cuda.synchronize()
        mx, nm = _rel_errs(h.float(), hp.float())
        diff = (h.float() - hp.float()).abs()
        fwd = dict(
            mode=mode, n=n, in_ch=in_ch, h_max_rel=mx, h_norm_rel=nm, max_abs_err=float(diff.max()),
            outside_budget=float((diff > DEFORM_OUT_MAX_REL * hp.float().abs().max()).float().mean()),
            emb_mismatch=int((emb != embp).sum()), act_mismatch=int((acts[:, :n] != actsp[:, :n]).sum()),
            ms=cuda_ms(lambda: mc.field_trunk_fwd(*fargs, True), reps=25),
            serve_ms=cuda_ms(lambda: mc.field_trunk_fwd(*fargs, False), reps=25),
            plain_ms=cuda_ms(lambda: mc.field_trunk_fwd_plain(*fargs, True), reps=5),
        )
        fwd["bound_ms"], fwd["bound_by"] = field_bound(n, in_ch, True, False, False, sources)
        fwd["serve_bound_ms"], fwd["serve_bound_by"] = field_bound(n, in_ch, False, False, False, sources)
        print("kernel field_fwd " + json.dumps(fwd))
        if not (torch.isfinite(h).all() and mx <= DEFORM_OUT_MAX_REL and nm <= DEFORM_OUT_NORM_REL):
            raise AssertionError(f"field_fwd ({mode}) vs plain: max rel {mx}, norm rel {nm}")

        g = torch.Generator(device="cpu").manual_seed(SEED + 17)
        dh = torch.randn(n, 256, generator=g).bfloat16().float().to(x.device)
        bargs = (xsrc, dh, wpack, emb, acts, sources, x_lanes)
        got = mc.field_trunk_bwd(*bargs)
        torch.cuda.synchronize()
        want = mc.field_trunk_bwd_plain(*bargs)
        torch.cuda.synchronize()
        lanes = sources * x_lanes
        named = [("dxsrc", got[0], want[0]), ("d_emb", got[1], want[1]), ("dW", got[2], want[2]), ("dbias", got[3], want[3])]
        if t_row.shape[0]:
            named.append(("dtrow", got[1][lanes : lanes + t_row.shape[0]], want[1][lanes : lanes + t_row.shape[0]]))
        errs = {name: _rel_errs(a, b) for name, a, b in named}
        outside = {
            name: float(((a - b).abs() > DEFORM_GRAD_MAX_REL * b.abs().max()).float().mean()) for name, a, b in named
        }
        bwd = dict(
            mode=mode, n=n, errs=errs, outside_budget=outside,
            max_abs_err=max(float((a - b).abs().max()) for _, a, b in named),
            ms=cuda_ms(lambda: mc.field_trunk_bwd(*bargs), reps=25),
            plain_ms=cuda_ms(lambda: mc.field_trunk_bwd_plain(*bargs), reps=5),
        )
        bwd["bound_ms"], bwd["bound_by"] = field_bound(n, in_ch, True, True, False, sources)
        print("kernel field_bwd " + json.dumps(bwd))
        for name, (emx, enm) in errs.items():
            if not (emx <= DEFORM_GRAD_MAX_REL and enm <= DEFORM_GRAD_NORM_REL):
                raise AssertionError(f"field_bwd ({mode}) vs plain, {name}: max rel {emx}, norm rel {enm}")
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"field_bwd ({mode}): non-finite gradients")
    return {"fwd": fwd, "bwd": bwd}


def phase_serve2(model2) -> dict:
    """The stage-2 serving path: the slider viewer over the stage-2 model at
    640x480 (tile 32), GET /render with non-zero sliders; each request runs
    the control trunk and the compositor once."""
    from freegaussian_tpu_torch.viewer.server import control_render_fn

    w, h = SERVE_WH
    lat, counts = _serve(
        control_render_fn(model2), w, h, VIEWS, "stage2", {"rasterize_fwd": 1, "field_fwd": 1},
        num_attributes=model2.num_attributes, atrbs=SLIDERS,
    )
    print(
        f"serve stage2 ({w}x{h} tile {model2.cfg.tile_size}, sliders): {len(lat)} requests, launches "
        f"{json.dumps(counts)}, latency first {lat[0]:.1f} ms, median of the rest {statistics.median(lat[1:]):.1f} ms"
    )
    return {"latency_ms": lat, "launches": counts}


def build_control_train_case(model2, width: int, height: int, device=None, target_seed: int = SEED + 19):
    """The stage-2 training phase's inputs: a trainable copy of the stage-2
    model's Gaussians and control field, its frozen deform field, the
    training config (tile 32, black background), the bench camera at t =
    0.5 with the init camera at INIT_TIME, and a seeded target: the stage-2
    model's frame with its SH DC colors shifted by N(0, 0.3). Returns
    (state, step_fn, camera, batch)."""
    import copy
    import dataclasses

    import torch

    from freegaussian_tpu_torch.engine.control_train_step import make_control_train_step
    from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
    from freegaussian_tpu_torch.engine.train_step import create_train_state
    from freegaussian_tpu_torch.models.control_model import control_forward

    device = device or DEVICE
    cfg = dataclasses.replace(model2.cfg, warm_up=0, background_color="black")
    params = {k: v.detach().to(device).clone() for k, v in model2.params.items()}
    alive = model2.alive.to(device).clone()
    mask = model2.gaussian_mask.to(device)
    deform = copy.deepcopy(model2.deform).to(device).requires_grad_(False)
    control = copy.deepcopy(model2.control).to(device).requires_grad_(True)
    camera = bench_camera(width, height, device, 0.5)
    g = torch.Generator(device="cpu").manual_seed(target_seed)
    shifted = dict(params, features_dc=params["features_dc"] + 0.3 * torch.randn(params["features_dc"].shape, generator=g).to(device))
    image = control_forward(cfg, shifted, alive, mask, camera, control, deform=deform, init_time=INIT_TIME,
                            sh_degree_now=3, train=False, render_mode="RGB")["rgb"]
    optimizers = make_optimizers(OptimizersConfig())
    state = create_train_state(
        params, alive, deform, optimizers, generator=torch.Generator(device=device).manual_seed(SEED), control=control
    )
    step_fn = make_control_train_step(cfg, optimizers, mask, INIT_TIME)
    return state, step_fn, camera, {"image": image}


def phase_train2(model2) -> dict:
    """The stage-2 training path: TRAIN_STEPS steps of
    `make_control_train_step` at 640x480, tile 32; the launch counts are
    zeroed just before the steps and read just after."""
    import torch

    width, height = SERVE_WH
    state, step_fn, camera, batch = build_control_train_case(model2, width, height)
    assert set(state.opt_states) == {"means", "scales", "quats", "features_dc", "features_rest", "opacities", "control"}
    losses, step_ms = [], []
    torch.cuda.synchronize()
    zero_launches()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, camera, batch, 3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(m[k]) for k in ("loss", "main_loss", "psnr")}
        if not bool(m["params_finite"]) or not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"stage-2 train step {i}: non-finite state or loss {vals}")
        losses.append(vals["loss"])
        line = {k: round(v, 6) for k, v in vals.items()}
        line.update(num_isects=int(m["num_isects"]), ms=round(step_ms[-1], 2))
        print(f"train2 step {i}: " + json.dumps(line))
    counts = launches()
    steady = statistics.median(step_ms[2:])
    pps = width * height / (steady / 1e3)
    print(
        f"train2 {width}x{height} tile {model2.cfg.tile_size}: launches {json.dumps(counts)} in {TRAIN_STEPS} steps; "
        f"median step {steady:.2f} ms over the last {TRAIN_STEPS - 2} (first {step_ms[0]:.1f} ms); "
        f"train_step_pixels_per_sec {pps:.0f}; loss step 0 {losses[0]:.6f} -> step {TRAIN_STEPS - 1} {losses[-1]:.6f}"
    )
    # per step: the deform trunk at the init time and at the frame's, then
    # the control trunk; one control-trunk backward; one compositor pair
    per_step = {"field_fwd": 3, "field_bwd": 1, "rasterize_fwd": 1, "rasterize_bwd": 1}
    want = {name: TRAIN_STEPS * per_step.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"launches {counts} in {TRAIN_STEPS} stage-2 train steps, want {want}")
    return {"launches": counts, "median_step_ms": steady, "pixels_per_sec": pps, "losses": losses}


def _check2_case(model2, over: dict, seed: int):
    """One stage-2 case on the GPU and on the CPU, at 160x120 on 4000
    Gaussians (the first 4000 at seed 0, else a seeded subset): the frame at
    the sliders SLIDERS[1] from a seeded orbit view, and one step against a
    seeded target. Returns ((|rgb diff|, |accumulation diff|, depth rel diff
    where accumulation > 0.5), (GPU loss, CPU loss), {group: {tensor: the
    relative L2 difference of its Adam first moment}})."""
    import dataclasses

    import torch

    from freegaussian_tpu_torch.models.control_model import ControlModel
    from freegaussian_tpu_torch.viewer.server import orbit_camera

    n = min(4000, N_GAUSS)
    rng = np.random.default_rng(SEED + 31 + seed)
    idx = torch.arange(n) if seed == 0 else torch.from_numpy(np.sort(rng.choice(N_GAUSS, n, replace=False)))
    small = ControlModel(dataclasses.replace(model2.cfg, **over), n, model2.num_attributes, device="cpu")
    with torch.no_grad():
        for k, v in model2.params.items():
            small.gauss_params[k].copy_(v.cpu()[idx])
        small.alive.copy_(model2.alive.cpu()[idx])
        small.gaussian_mask.copy_(model2.gaussian_mask.cpu()[idx])
        small.deform.load_state_dict({k: v.float().cpu() for k, v in model2.deform.state_dict().items()})
        small.control.load_state_dict({k: v.float().cpu() for k, v in model2.control.state_dict().items()})
    frames, steps = {}, {}
    for dev in (DEVICE, "cpu"):
        on_dev = small.to(dev)
        cam = orbit_camera(0.7 + 0.9 * seed, 0.2, 4.0, width=160, height=120, time=0.3, device=dev)
        out = on_dev(cam, 0.1 * SLIDERS[1])
        frames[dev] = {k: out[k].float().cpu() for k in ("rgb", "accumulation", "depth")}
        state, step_fn, camera, batch = build_control_train_case(on_dev, 160, 120, device=dev, target_seed=SEED + 19 + seed)
        state, m = step_fn(state, camera, batch, 3)
        steps[dev] = (float(m["loss"]), {g: {k: v.cpu() for k, v in st.mu.items()} for g, st in state.opt_states.items()})
        small = small.to("cpu")
    gf, cf = frames[DEVICE], frames["cpu"]
    for k in gf:
        assert torch.isfinite(gf[k]).all(), k
    assert float(cf["accumulation"].max()) > 0.9 and float(gf["rgb"].std()) > 0.01, "empty frame"
    seen = cf["accumulation"] > 0.5
    frame = (
        float((gf["rgb"] - cf["rgb"]).abs().max()),
        float((gf["accumulation"] - cf["accumulation"]).abs().max()),
        float(((gf["depth"] - cf["depth"]).abs() / cf["depth"].abs().clamp(min=1e-6))[seen].max()),
    )
    (lg, mug), (lc, muc) = steps[DEVICE], steps["cpu"]
    rel = {
        g: {k: float((mug[g][k] - w).norm() / w.norm().clamp(min=1e-30)) for k, w in moments.items()}
        for g, moments in muc.items()
    }
    return frame, (lg, lc), rel


def phase_check2(model2):
    """Stage-2 frames and steps on the GPU against the same on the CPU
    (`_check2_case`), held to the stage-1 checks' budgets: frame CHECK_ATOL,
    loss rtol 1e-4, and every tensor of the Adam first moments, by its
    relative L2 difference, TRAIN_CHECK_RTOL. With the fields in f32
    (split-linear chains on both devices) one case; under "pallas" (the
    field-trunk kernels against their plain versions) CHECK2_SEEDS cases,
    the control field's tensors within TRAIN_CHECK_KERNEL_CONTROL_RTOL.
    Every case is printed before any is held."""
    variants = (
        ("f32", dict(deform_impl="headsfused", deform_bf16=False), 1, {}),
        ("pallas", dict(deform_impl=STAGE2_IMPL), CHECK2_SEEDS, {"control": TRAIN_CHECK_KERNEL_CONTROL_RTOL}),
    )
    faults = []
    for label, over, seeds, looser in variants:
        for seed in range(seeds):
            t0 = time.perf_counter()
            frame, (lg, lc), rel = _check2_case(model2, over, seed)
            worst = {g: max(r.items(), key=lambda kv: kv[1]) for g, r in rel.items()}
            print(
                f"check2 {label} seed {seed} 160x120 GPU vs CPU: frame max |rgb diff| {frame[0]:.3g}, |accumulation "
                f"diff| {frame[1]:.3g}, depth rel diff where accumulation > 0.5 {frame[2]:.3g} (limit {CHECK_ATOL}); "
                f"step loss {lg:.7f} vs {lc:.7f} (rtol 1e-4); Adam first moment, relative L2 difference of the worst "
                f"tensor of each group {json.dumps({g: [k, float(f'{v:.3g}')] for g, (k, v) in worst.items()})} "
                f"(limit {looser.get('control', TRAIN_CHECK_RTOL)} for the control field's, {TRAIN_CHECK_RTOL} for "
                f"the rest), median of "
                f"the control field's {statistics.median(rel['control'].values()):.3g}; {time.perf_counter() - t0:.1f} s"
            )
            if not max(frame) <= CHECK_ATOL:
                faults.append(f"{label} seed {seed}: the GPU frame differs from the CPU frame by {max(frame)}")
            if not abs(lg - lc) <= 1e-4 * abs(lc):
                faults.append(f"{label} seed {seed}: step loss {lg} on the GPU, {lc} on the CPU")
            for g, (k, v) in worst.items():
                if v > looser.get(g, TRAIN_CHECK_RTOL):
                    faults.append(f"{label} seed {seed}: {g}.{k} differs by {v}")
    if faults:
        raise AssertionError("stage-2 GPU vs CPU: " + "; ".join(faults))


# ---------------------------------------------------------------------------
# slice 4: the train and train-control verbs
# ---------------------------------------------------------------------------

DATA_FRAMES = 8
VERB_STEPS = 30
VERB_EVAL_AT = 20  # the step of the train verb's one eval of every frame
CONTROL_VERB_STEPS = 10
FWD_WALK_STEPS = 3
# padded capacity of the verbs' states: the trainer inits min(num_random,
# capacity / 2) Gaussians, so 2^18 holds N = 1e5 (the JAX package's default is 2^19)
VERB_CAPACITY = 1 << 18


def phase_dataset(tmp: Path, model) -> Path:
    """A synthetic dataset at 640x480 in parse_synthetic's layout
    (transforms.json, images/, depth/, interflow_n2/, mask/): DATA_FRAMES
    frames rendered by the port from the bench scene at their frame times
    (i / 7) from an orbit at radius 6 (focal 500), seeded depth (U(3, 8)),
    interflow (N(0, 1) px) and (H, W, 3) attribute masks (seeded boxes).
    `parse_synthetic` reads no seed points: the train verb starts from
    `num_random` random Gaussians."""
    import math

    from freegaussian_tpu_torch.viewer.png import encode_png
    from freegaussian_tpu_torch.viewer.server import orbit_camera, to_rgb8

    t0 = time.perf_counter()
    width, height = SERVE_WH
    root = tmp / "scene_data"
    for sub in ("images", "depth", "interflow_n2", "mask"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(SEED + 41)
    frames = []
    for i in range(DATA_FRAMES):
        cam = orbit_camera(-0.6 + 1.2 * i / (DATA_FRAMES - 1), 0.15, 6.0, width=width, height=height, fx=500.0,
                           time=i / (DATA_FRAMES - 1), device=DEVICE)
        (root / f"images/frame_{i:04d}.png").write_bytes(encode_png(to_rgb8(model(cam)["rgb"])))
        np.save(root / f"depth/frame_{i:04d}.npy", rng.uniform(3.0, 8.0, size=(height, width, 1)).astype(np.float32))
        np.save(root / f"interflow_n2/frame_{i:04d}.npy", rng.normal(size=(height, width, 2)).astype(np.float32))
        mask = np.zeros((height, width, 3), bool)
        for c in range(3):
            y, x = rng.integers(0, height // 2), rng.integers(0, width // 2)
            mask[y : y + height // 3, x : x + width // 3, c] = True
        np.save(root / f"mask/{i:04d}.npy", mask)
        c2w = np.eye(4)
        c2w[:3] = cam.c2w.cpu().numpy()
        frames.append({"file_path": f"./images/frame_{i:04d}", "transform_matrix": c2w.tolist()})
    meta = {"camera_angle_x": 2.0 * math.atan(0.5 * width / 500.0), "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    mib = sum(f.stat().st_size for f in root.rglob("*") if f.is_file()) / 2**20
    print(f"dataset: {DATA_FRAMES} frames at {width}x{height} in parse_synthetic's layout, {mib:.1f} MiB, "
          f"written in {time.perf_counter() - t0:.1f} s")
    return root


def _verb_metrics(out: Path):
    rows = [json.loads(line) for line in (out / "freegaussian" / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if "loss" in r], [r for r in rows if "eval" in r]


def phase_train_verb(tmp: Path, data: Path) -> dict:
    """The `train` verb in process, `cli.main(["train", ...])`, on
    configs/sim/base.yaml (flow losses, tensorboard) with overrides: warm-up
    0, no downscale, refine_start / refine_every 10, VERB_STEPS steps, one
    eval of every frame at step VERB_EVAL_AT, N = 1e5 random Gaussians in a padded
    capacity of 2^18, tile 32, the deform field on its kernel pair (the
    port's default "fused"); the checkpoint it saves at the end reloads
    equal. Launches are zeroed just before the verb and read just after."""
    import torch

    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.engine import checkpoints

    out = tmp / "train_out"
    over = tmp / "train_over.yaml"
    over.write_text(
        f"max_num_iterations: {VERB_STEPS}\nnum_random: {N_GAUSS}\nsteps_per_log: 1\nsteps_per_save: 0\n"
        f"steps_per_eval_image: 0\nsteps_per_eval_all_images: {VERB_EVAL_AT}\noutput_dir: {out}\n"
        "pipeline:\n  model:\n    warm_up: 0\n    num_downscales: 0\n    refine_start: 10\n    refine_every: 10\n"
    )
    argv = ["train", "--data", str(data), "--config", str(HERE / "configs/sim/base.yaml"), "--scene-config", str(over),
            "--capacity", str(VERB_CAPACITY), "--device", DEVICE]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    train_rows, eval_rows = _verb_metrics(out)
    losses = [r["loss"] for r in train_rows]
    if len(train_rows) != VERB_STEPS or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"train verb: {len(train_rows)} logged steps, losses {losses}")
    step_ms = [1e3 / r["steps_per_sec"] for r in train_rows]
    # the first epoch loads each frame to the device; the step after the eval is billed from the eval's end
    steady = statistics.median(step_ms[DATA_FRAMES:])
    print(f"train verb: {VERB_STEPS} steps in {wall:.1f} s (setup, steps, eval, save); loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; gaussians {int(train_rows[0]['gaussian_count'])} -> {int(train_rows[-1]['gaussian_count'])}; "
          f"step ms first {step_ms[0]:.1f}, median over the first epoch {statistics.median(step_ms[:DATA_FRAMES]):.2f}, "
          f"median after it {steady:.2f} ({1e3 / steady:.2f} steps/s, {SERVE_WH[0] * SERVE_WH[1] / (steady / 1e3):.0f} px/s)")
    print(f"train verb eval: {json.dumps(eval_rows)}")
    print(f"train verb launches: {json.dumps(counts)}")
    for name in ("rasterize_fwd", "rasterize_bwd", "deform_fwd", "deform_bwd"):
        if not counts[name] > 0:
            raise AssertionError(f"train verb launched {name} {counts[name]} times")
    if counts["rasterize_bwd_fwd"] != 0 or len(eval_rows) != VERB_STEPS // VERB_EVAL_AT:
        raise AssertionError(f"train verb: launches {counts}, eval rows {eval_rows}")
    # the checkpoint the verb saved at its last step reloads equal
    ckpt = out / "freegaussian" / "checkpoints"
    saved = checkpoints.state_dict(trainer.state)
    with torch.no_grad():
        trainer.state.params["means"].add_(1.0)
    trainer.load(ckpt)
    reloaded = checkpoints.state_dict(trainer.state)
    _assert_nested_equal(saved, reloaded, "checkpoint")
    print(f"train verb checkpoint: step {reloaded['step']}, {sum(f.stat().st_size for f in ckpt.rglob('*') if f.is_file()) / 2**20:.1f} MiB, reloads equal")
    return {"trainer": trainer, "ckpt": ckpt, "launches": counts, "median_step_ms": steady, "losses": losses}


def _assert_nested_equal(a, b, path):
    import torch

    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{path}: keys differ")
        for k in a:
            _assert_nested_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{path} differs")
    elif a != b:
        raise AssertionError(f"{path}: {a} != {b}")


def phase_train_control_verb(tmp: Path, data: Path, ckpt: Path, trainer) -> dict:
    """The `train-control` verb in process over the train verb's checkpoint,
    on configs/control/sim/base.yaml with deform_impl "pallas" (the field
    trunk kernels), a seeded cluster mask over the checkpoint's live
    Gaussians (three spatial balls), CONTROL_VERB_STEPS steps. Launches
    are zeroed just before the verb and read just after."""
    import torch

    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.preprocess.clustering import save_gaussian_mask

    alive = trainer.state.alive
    mask = synthetic_mask(trainer.state.params["means"].detach()[alive].cpu().numpy())
    full = torch.zeros((alive.shape[0], mask.shape[1]), dtype=torch.bool)
    full[alive.cpu()] = torch.from_numpy(mask)
    mask_path = tmp / f"gaussian_mask_{mask.shape[0]}x{mask.shape[1]}.npy"
    save_gaussian_mask(mask_path, full, alive.cpu())
    out = tmp / "control_out"
    over = tmp / "control_over.yaml"
    over.write_text(f"max_num_iterations: {CONTROL_VERB_STEPS}\nnum_random: {N_GAUSS}\nsteps_per_log: 1\noutput_dir: {out}\n")
    argv = ["train-control", "--data", str(data), "--config", str(HERE / "configs/control/sim/base.yaml"),
            "--scene-config", str(over), "--stage1-checkpoint", str(ckpt), "--gaussian-mask", str(mask_path),
            "--deform-impl", STAGE2_IMPL, "--capacity", str(VERB_CAPACITY), "--device", DEVICE]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ctrainer = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    rows, _ = _verb_metrics(out)
    losses = [r["loss"] for r in rows]
    if len(rows) != CONTROL_VERB_STEPS or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"train-control verb: {len(rows)} logged steps, losses {losses}")
    assert ctrainer.state.control.impl == STAGE2_IMPL and ctrainer.state.deform.impl == STAGE2_IMPL
    step_ms = [1e3 / r["steps_per_sec"] for r in rows]
    print(f"train-control verb: {CONTROL_VERB_STEPS} steps in {wall:.1f} s; mask {mask.shape} over "
          f"{mask.any(1).mean():.1%} of the live Gaussians; loss {losses[0]:.6f} -> {losses[-1]:.6f}; step ms first "
          f"{step_ms[0]:.1f}, median after the first epoch {statistics.median(step_ms[DATA_FRAMES:]):.2f}; "
          f"launches {json.dumps(counts)}")
    for name in ("field_fwd", "field_bwd", "rasterize_fwd", "rasterize_bwd"):
        if not counts[name] > 0:
            raise AssertionError(f"train-control verb launched {name} {counts[name]} times")
    return {"launches": counts, "median_step_ms": statistics.median(step_ms[DATA_FRAMES:])}


def phase_fwd_walk(trainer) -> dict:
    """FWD_WALK_STEPS more steps of the train verb's trainer with
    `rasterize_cuda.BWD_WALK = "fwd"` (the JAX package's knob): the
    compositor's backward is the forward walk, row 3, and not row 2."""
    import torch

    from freegaussian_tpu_torch.ops import rasterize_cuda

    torch.cuda.synchronize()
    zero_launches()
    rasterize_cuda.BWD_WALK = "fwd"
    try:
        t0 = time.perf_counter()
        metrics = trainer.train(FWD_WALK_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rasterize_cuda.BWD_WALK = "rev"
    counts = launches()
    print(f"fwd walk: {FWD_WALK_STEPS} train steps in {wall:.2f} s under BWD_WALK \"fwd\", loss {metrics['loss']:.6f}; "
          f"launches {json.dumps(counts)}")
    if not np.isfinite(metrics["loss"]) or counts["rasterize_bwd_fwd"] != FWD_WALK_STEPS or counts["rasterize_bwd"] != 0:
        raise AssertionError(f"fwd walk: loss {metrics['loss']}, launches {counts}")
    return {"launches": counts}


def phase_trunk(model) -> dict:
    """The deform field with per-point times at N = 1e5 (its trunk on the
    precomputed embedding, rows 4-5), forward and backward through autograd
    with the launch counts zeroed just before and read just after; then
    each kernel against its plain version on the captured inputs."""
    import copy

    import torch

    from freegaussian_tpu_torch.ops import mlp_cuda as mc

    deform = copy.deepcopy(model.deform).requires_grad_(True)
    x = model.params["means"].detach().clone()
    g = torch.Generator(device="cpu").manual_seed(SEED + 23)
    t = torch.rand(x.shape[0], 1, generator=g).to(x.device)
    real, calls = mc.trunk_fwd, []

    def capture(*args):
        calls.append(args)
        return real(*args)

    torch.cuda.synchronize()
    zero_launches()
    mc.trunk_fwd = capture
    try:
        d_xyz, rot, scl = deform(x, t)
        loss = d_xyz.w.sum() + (d_xyz.v ** 2).sum() + d_xyz.theta.sum() + rot.sum() + (scl ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
    finally:
        mc.trunk_fwd = real
    counts = launches()
    print(f"trunk: DeformField with per-point times, N = {x.shape[0]}, forward and backward; launches {json.dumps(counts)}")
    if counts["trunk_fwd"] != 1 or counts["trunk_bwd"] != 1 or counts["deform_fwd"] or counts["field_fwd"]:
        raise AssertionError(f"per-point times launched {counts}")
    if not all(torch.isfinite(p.grad).all() for p in deform.parameters()):
        raise AssertionError("per-point deform field: non-finite gradients")

    inp, wpack, bias, _ = calls[0]
    n = inp.shape[0]
    with torch.no_grad():
        h, (emb, acts) = mc.trunk_fwd(inp, wpack, bias, True)
        torch.cuda.synchronize()
        hp, (embp, actsp) = mc.trunk_fwd_plain(inp, wpack, bias, True)
        mx, nm = _rel_errs(h.float(), hp.float())
        diff = (h.float() - hp.float()).abs()
        in_ch = 63 + 30
        fwd = dict(
            n=n, h_max_rel=mx, h_norm_rel=nm, max_abs_err=float(diff.max()),
            outside_budget=float((diff > DEFORM_OUT_MAX_REL * hp.float().abs().max()).float().mean()),
            emb_mismatch=int((emb != embp).sum()), act_mismatch=int((acts[:, :n] != actsp[:, :n]).sum()),
            ms=cuda_ms(lambda: mc.trunk_fwd(inp, wpack, bias, True), reps=25),
            serve_ms=cuda_ms(lambda: mc.trunk_fwd(inp, wpack, bias, False), reps=25),
            plain_ms=cuda_ms(lambda: mc.trunk_fwd_plain(inp, wpack, bias, True), reps=5),
        )
        fwd["bound_ms"], fwd["bound_by"] = trunk_bound(n, in_ch, True, False)
        fwd["serve_bound_ms"], fwd["serve_bound_by"] = trunk_bound(n, in_ch, False, False)
        print("kernel trunk_fwd " + json.dumps(fwd))
        if not (torch.isfinite(h).all() and mx <= DEFORM_OUT_MAX_REL and nm <= DEFORM_OUT_NORM_REL and fwd["emb_mismatch"] == 0):
            raise AssertionError(f"trunk_fwd vs plain: max rel {mx}, norm rel {nm}, emb mismatches {fwd['emb_mismatch']}")

        dh = torch.randn(n, 256, generator=g).bfloat16().float().to(x.device)
        got = mc.trunk_bwd(dh, wpack, emb, acts)
        torch.cuda.synchronize()
        want = mc.trunk_bwd_plain(dh, wpack, emb, acts)
        named = [("d_emb", got[0], want[0]), ("dW", got[1], want[1]), ("dbias", got[2], want[2])]
        errs = {name: _rel_errs(a, b) for name, a, b in named}
        bwd = dict(
            n=n, errs=errs, max_abs_err=max(float((a - b).abs().max()) for _, a, b in named),
            d_emb_nonzero_past_fan_in=int((got[0][:, in_ch:] != 0).sum()),
            ms=cuda_ms(lambda: mc.trunk_bwd(dh, wpack, emb, acts), reps=25),
            plain_ms=cuda_ms(lambda: mc.trunk_bwd_plain(dh, wpack, emb, acts), reps=5),
        )
        bwd["bound_ms"], bwd["bound_by"] = trunk_bound(n, in_ch, True, True)
        print("kernel trunk_bwd " + json.dumps(bwd))
        for name, (emx, enm) in errs.items():
            if not (emx <= DEFORM_GRAD_MAX_REL and enm <= DEFORM_GRAD_NORM_REL):
                raise AssertionError(f"trunk_bwd vs plain, {name}: max rel {emx}, norm rel {enm}")
        if bwd["d_emb_nonzero_past_fan_in"] or not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"trunk_bwd: {bwd['d_emb_nonzero_past_fan_in']} non-zero lanes past the fan-in, or non-finite")
    return {"launches": counts, "fwd": fwd, "bwd": bwd}


def trunk_bound(n: int, in_ch: int, save: bool, backward: bool):
    """Least time (ms) the card could take for one call of the trunk on a
    precomputed embedding, and what sets it: `field_bound`'s operations
    (the trunk's products, twice backward) against its bytes with the
    (N, 128) f32 embedding read (forward) or d emb written (backward) in
    place of the sources and dx."""
    trunk = 2.0 * n * 256 * (2 * in_ch + 7 * 256) * (2 if backward else 1)
    t_ops = trunk / PEAK_BF16_OPS * 1e3
    if backward:
        io = 4 * 256 + 4 * 128  # dh in, d emb out
    else:
        io = 4 * 128 + (0 if save else 2 * 256)  # the embedding in, h out (in training the last saved activation)
    per_row = io + (2 * (128 + 8 * 256) if (save or backward) else 0)
    weights = 256 * (2 * in_ch + 7 * 256) * (2 + (4 if backward else 0))
    t_bytes = (n * per_row + weights) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
        _, _, model2 = phase_scene2(Path(tmp), model)
        kern2 = phase_kernels2(model2)
        serve2 = phase_serve2(model2)
        train2 = phase_train2(model2)
        phase_check2(model2)
        data = phase_dataset(Path(tmp), model)
        verb = phase_train_verb(Path(tmp), data)
        control_verb = phase_train_control_verb(Path(tmp), data, verb["ckpt"], verb["trainer"])
        fwd_walk = phase_fwd_walk(verb["trainer"])
        trunk = phase_trunk(model)
        del verb["trainer"]
    print(
        f"train verb median step {verb['median_step_ms']:.2f} ms against phase 7's bare step "
        f"{train['median_step_ms']:.2f} ms in this run ({verb['median_step_ms'] / train['median_step_ms']:.2f}x); "
        f"train-control verb {control_verb['median_step_ms']:.2f} ms against phase 11's {train2['median_step_ms']:.2f} ms"
    )
    main_row = next(r for r in kern["rows"] if r["tile"] == model.cfg.tile_size and r["C"] == 4)
    bwd_row = next(r for r in kern["bwd_rows"] if r["frame"] == "bench" and r["walk"] == "rev" and r["tile"] == train["tile"] and r["C"] == 5)
    bwd_fwd_row = next(r for r in kern["bwd_rows"] if r["frame"] == "bench" and r["walk"] == "fwd" and r["tile"] == train["tile"] and r["C"] == 5)

    def record(name, source, replaces, launches_, max_abs_err, row):
        return {
            "name": name, "route": "cuda", "source": f"freegaussian_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches_, "max_abs_err": max_abs_err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        }

    records = [
        record("rasterize_fwd", "rasterize_fwd.cu", "freegaussian_tpu/ops/rasterize_pallas.py:523",
               serve["main"]["launches"]["rasterize_fwd"], kern["max_abs_err"], main_row),
        record("rasterize_bwd", "rasterize_bwd.cu", "freegaussian_tpu/ops/rasterize_pallas.py:857",
               train["launches"]["rasterize_bwd"], kern["bwd_max_abs_err"], bwd_row),
        record("rasterize_bwd_fwd", "rasterize_bwd.cu", "freegaussian_tpu/ops/rasterize_pallas.py:627",
               fwd_walk["launches"]["rasterize_bwd_fwd"], kern["bwd_fwd_max_abs_err"], bwd_fwd_row),
    ]
    for name, line, mode in (("deform_fwd", 537, "fwd"), ("deform_bwd", 555, "bwd")):
        row = kern["deform"][mode]
        records.append(record(name, "deform_field.cu", f"freegaussian_tpu/ops/mlp_pallas.py:{line}",
                              train["launches"][name], row["max_abs_err"], row))
    # the control trunk's rows (the stage-2 path's training call); launches
    # of both stage-2 paths: 3 forwards a step and 1 a request, 1 backward a step
    for name, line, mode in (("field_fwd", 476, "fwd"), ("field_bwd", 484, "bwd")):
        records.append(record(
            name, "deform_field.cu", f"freegaussian_tpu/ops/mlp_pallas.py:{line}",
            train2["launches"][name] + serve2["launches"][name],
            max(kern2[m][mode]["max_abs_err"] for m in ("control", "deform")), kern2["control"][mode],
        ))
    for name, line, mode in (("trunk_fwd", 155, "fwd"), ("trunk_bwd", 167, "bwd")):
        records.append(record(name, "deform_field.cu", f"freegaussian_tpu/ops/mlp_pallas.py:{line}",
                              trunk["launches"][name], trunk[mode]["max_abs_err"], trunk[mode]))
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
