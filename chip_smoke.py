"""Smoke run of the PyTorch port (`freegaussian_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's stage-1 serving path (reference checkpoint ->
`forward(train=False)` -> HTTP viewer), its stage-1 training step
(`make_train_step`: forward, loss, backward, Adam, densification), its
stage-2 control path in the `deform_impl="pallas"` configuration (the
slider viewer over a stage-2 checkpoint, and `make_control_train_step`),
the `train` and `train-control` CLI verbs over a dataset on disk, the
`viewer` verb over the checkpoints those verbs write, the `cluster`,
`eval`, `render` and `export` verbs that complete the two-stage pipeline,
the real-capture front end (`interflow`, undistortion, the LiveScene
real and CoNeRF parsers, polygon masks), camera optimization and the
bilateral grid in the stage-1 step, band frames, and the multi-GPU step at
world size 1, with every kernel built from this checkout. Phases, printed as each ends:

  1. device   the card's name and power limit, as nvidia-smi gives them
  2. build    nvcc builds every kernel source, one process per source, all
              started together; each kernel's registers, spills and static
              shared memory from ptxas
  3. scene    a seeded synthetic scene at the bench.py operating point
              (100k Gaussians, SH degree 3, scales log(0.015), the 50/30/20
              opacity mixture, a full 8x256 deform field with heads x 0.01),
              written as a reference checkpoint and loaded back
  4. kernels  each kernel against its plain PyTorch version on the inputs
              the main paths give it (640x480; tiles 16 and 32): the
              compositor at C = 3 and 4, and at C = 1 on the ED channel
              (the cluster vote's frame; its color budget times the
              channel's largest value), livecnt and t_final bit for bit,
              two calls bit-equal; its backward by both walks at C
              = 3 and 5 with seeded cotangents (the forward walk also on a
              sparse frame, every tenth Gaussian), the fused deform field's forward (100k
              means, the scene's weights and time row) and its backward
              with a seeded cotangent: max |diff|, elements outside the
              budget, kernel and plain ms (CUDA events; the field forward in
              training and serving modes), and the least time the card
              could take (the bound); each backward's two launches
              timed apart (the compositor's quadrant walk and combine, the
              field's data-gradient walk and weight-gradient pass, with the
              bytes the latter moves at its tile sizes), and two calls of
              each backward compared bit for bit; the error of the
              per-Gaussian reduction of the backward's rows (f32 prefix
              sums) against a float64 sum at tile 32; then the deform
              field at the trainer's shape (`kernel deform live` lines):
              2^18 rows, the 1e5 means and stale copies, with 1e5 live at
              the head and again holed over two of every three 128-row
              blocks: the kernels with the mask against the plain versions
              with it on the live rows, the rows of live blocks bit-equal
              to the padded call (no mask) in the output and dx, the dead
              blocks zero, two calls bit-equal; ms with the mask and
              without it, the block list's ms, the backward's two launches,
              and the bound at the live count; and the split-linear chain
              (`DeformField(impl="split")`, cuBLAS) at 1e5 and 2^18 rows
              as a reference reading
  5. serve    the serving path: the HTTP viewer answers GET /render (JPEG) at
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
              frame's time and the paired frame's, one Adam update of every
              group), and the refine's split /
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
              plain ms and the bound; the backward's launches timed apart
              and two calls compared bit for bit, as in phase 4; each
              mode at the trainer's shape as phase 4's deform field
              (`kernel field (control|deform) live` lines)
 10. serve2   the stage-2 serving path: the slider viewer answers GET
              /render with non-zero sliders at 640x480 (tile 32); latency,
              and launches zeroed before the requests and read after (one
              control-trunk forward and one compositor per request); three
              times over, each with its host probe
 11. train2   the stage-2 training path: 12 steps of
              `make_control_train_step` against a seeded target; the loss of
              every step, the median step time and train_step_pixels_per_sec,
              launches per step (three field-trunk forwards: the deform
              trunk at the init time and at the frame's, the control trunk;
              one field-trunk backward; one compositor and its backward;
              one Adam update of every group)
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
              the kernel pair against its plain versions, ms, bound, and the
              backward's launches as in phase 4, and at the trainer's shape
              (`kernel trunk live` lines)
 18. viewer   the `viewer` verb in process (`cli.serve_viewer`) over the
     verb     `train` verb's checkpoint directory (stage 1: `--data --load`)
              and over the `train-control` verb's (stage 2:
              `--stage1-checkpoint --gaussian-mask --load`): the served state
              is the verb's last step, GET /render answers image/jpeg with
              the JPEG of the trainer's own frame for that camera, and each
              request launches the field forward and the compositor once
 19. pipeline the remaining verbs in process (`cli.main`) over phase 14's
              checkpoint directory and phase 13's dataset, each verb's
              launches zeroed just before it and read just after, its setup
              (trainer and checkpoint) and work seconds apart: `cluster`
              over every frame (the mask in the dataset directory) and
              `cluster --dynamic` over six key frames of a key_frames yaml,
              one compositor at C = 1 per key frame and, dynamic, one deform
              field forward per key frame; each vote against the vote by
              the plain compositor on the same inputs (at most 0.1% of the
              live rows differ); `train-control` for 5 steps on the cluster
              verb's mask; `eval` of stage 1 and stage 2 with --dump-images
              and --report (one compositor and one deform field forward, or
              three field-trunk forwards, per frame), LPIPS from seeded
              weights (no quality number) on the card against the CPU's on
              the same frames; `render` over the dataset's cameras and an
              8-frame orbit (the compositor at C = 3 for rgb and C = 4 for
              depth); `export` as PLY (read back equal to the live
              parameters) and as a reference checkpoint (loaded by the port,
              it renders the trainer's frame within 1e-6); eval fps, cluster
              ms per key frame and render ms per frame beside the card
 20. captures the real-capture front end (`captures` lines): an 8-frame
              LiveScene real capture at 640x480 in nerfstudio's layout (JPEG,
              per-frame intrinsics, a Brown distortion with k1, k2, p1, p2
              non-zero, M = 2 masks, foreground masks, sparse_pc.ply of every
              fourth bench mean), the bench scene moved into the frame
              parse_real gives it, rendered through each pinhole camera and
              distorted by the port's undistort_points; `undistort_frame` of a
              frame on the card against the CPU (camera, ROI and every array
              bit-equal; ms a frame); the `interflow` verb in both forms from
              the scene's depth renders and seeded optical flow, against the
              CPU (1e-4 of the largest flow); the `train` verb on it
              (configs/real/base.yaml, warm-up 0, 24 steps, one eval): setup
              and its undistortion share (each call's span on the loader
              threads, and their union), step ms against phase 7's, rows 1,
              2, 8 and 9 launched; `eval` of the moved bench scene against
              the undistorted frames (PSNR at least 25); an 8-frame CoNeRF
              capture at 1296x968 read at rgb/2x (648x484: partial tile rows
              and columns) with polygon annotations on 3 key frames and
              values.yaml: 10 `train` steps (configs/conerf/base.yaml) and
              `cluster` over its polygon masks with the bench scene, the vote
              against the plain compositor's. On each capture's own frame
              (639x479 undistorted with cx 309.3; 648x484), the bench scene
              in its frame: the compositor forward and backward against their
              plain versions at every (C, tile) the verbs' calls took at that
              size, and the deform field, with phase 4's budgets
              (`captures kernels` lines)
 21. extras   camera optimization (SO3xR3) and the bilateral grid in the
              stage-1 step (`extras` lines): one step on the card against
              the CPU as phase 7's check does (4000 Gaussians at 160x120),
              and at the bench point one step with the kernels against one
              with the plain compositor on the card (the loss to rtol 1e-4,
              camera_opt's and bilateral_grid's Adam first moments within
              1e-4 relative L2, every other within 1e-2); at the bench
              point, 30 rounds of steps without the extras, with each alone
              and with both, in turns (median ms, launches); the grid's
              slice, its TV loss and the camera adjustment (ms); the `train`
              verb with both enabled by the YAML overlay over phase 13's
              dataset (10 steps), its checkpoint reloaded equal, and `eval`
              over it
 22. bands    the bench frame rendered in horizontal bands through the
              compositor and its backward (rows 1 and 2 on band frames: 2
              bands of 240 rows at tile 16 and at tile 32, the geometry of
              phase 23's (1, 2) mesh, 3 of 160 at tile 32): each band's
              kernels against their plain versions with phase 4's budgets;
              stitched, against the full frame: the forward within phase
              4's budget, the per-Gaussian gradients summed over the bands
              at the backward's budget, and where the band tile grid is the
              frame's the kernel rows pair for pair and the bands'
              intersections summing to the frame's; each band's kernel ms
              and launches (`bands` lines)
 23. parallel `make_parallel_train_step` at (data 1, tile 1) over NCCL, world
              size 1 on this card, the process group set up here: one step
              against the single-GPU step from the same state and draws
              (loss rtol 1e-4, Adam first moments and the updates within
              1e-2 relative L2), then 60 steps of each in turns (ms, the
              parallel steps' launches); then two ranks on this card over
              gloo with CUDA tensors (gloo runs every collective the step
              uses on them; it aborts on point-to-point sends, which the
              step does not use; PERF.md §7) at (1, 2) and
              (2, 1): one step against the single steps (loss, first
              moments), the ranks' parameters bit-equal
 24. graphs   the capacity-bounded binning and `scan_chunk` as CUDA-graph
              replays (`graphs` lines): rows 1 and 2 on slot lists padded
              to 6 slots a Gaussian and overflowing at 3/4 of the pairs,
              against their plain versions with phase 4's budgets, the
              padding rows zero, the overflow's kept pairs the CPU
              binning's; the reduction's ms at the padded capacity; the
              ellipse cull on against off (pairs, binning ms, the frame
              within 2e-5); then stage 1 and stage 2 with `scan_chunk` 10
              (two chunks, stage 1 with a refinement inside the second)
              against the eager per-step loop from the same state, built
              as the `train` and `train-control` verbs build them: losses
              (rtol 1e-4), every parameter and first moment (max |diff|,
              and relative L2 within 1e-2), then the wall ms per step of
              each in turns, one profiler window of a chunk each (busy
              share, device events per step), the capture time and the
              launches with the replays' (a capture or replay failure
              raises; there is no eager fallback)
 25. sweep    the eval sweep (`sweep` lines): `eval_all` of stage 1 and
              stage 2 over phase 13's 8 frames with the bench scene loaded
              as in phase 24, LPIPS off (FREEGAUSSIAN_LPIPS_WEIGHTS set to a
              missing file): one CUDA graph a sweep, captured in the first
              call after its eager warm-up frame, replayed once a frame;
              each frame's PSNR and SSIM against the per-frame loop's on the
              same trainer (within 1e-5); the launches of each call (8
              `rasterize_fwd` + 8 `deform_fwd`, 8 + 24 `field_fwd`); then
              eval_all with the sweep and with the loop in turns, 5 rounds
              each (fps), the first call and the capture apart, and one
              profiler window of each (busy share)
 26. adam     Adam's one-pass kernel (`csrc/adam.cu`) at the training
              cells' shapes (`adam` lines): the six Gaussian tensors at
              capacity 2^19, SH degree 3, 1e5 live slots at the head, and
              the 8x256 deform field's (stage 1) or control field's (stage
              2) weights, the SH gradients slices of one (2^19, 16, 3)
              gradient as the step's are; one step of the kernel against the plain chain
              from the same state, bit for bit; then each timed as replays
              of a CUDA graph of one call, as the training step runs it:
              the kernel, its bound (each element's p, g, mu and nu read
              once and p, mu and nu written once, and the mask, at HBM3's
              3.35 TB/s), the plain chain, and `torch._fused_adam_` over
              the same tensors as a yardstick that the port never calls (it
              leaves out the mask and takes one rate for all groups)

Then one JSON line of kernel records (row 10, Adam's, after the nine of
the bring-up table) and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Nothing catches a failure: any fault raises and the exit code is not 0. It
needs a CUDA GPU, nvcc ($CUDA_HOME or /usr/local/cuda) and this checkout,
and exits non-zero without them. It uses no network: the viewer binds
127.0.0.1.
"""

from __future__ import annotations

import contextlib
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
# one stage-1 training step's launches: the deform field runs at the frame's
# time and at the paired frame's; one Adam update of every group
STEP_LAUNCHES = {"rasterize_fwd": 1, "rasterize_bwd": 1, "deform_fwd": 2, "deform_bwd": 2, "adam": 1}


def kernel_modules():
    """The port's modules that launch kernels, each with its LAUNCHES and KERNEL_SOURCES."""
    from freegaussian_tpu_torch.ops import adam_cuda, mlp_cuda, rasterize_cuda

    return (rasterize_cuda, mlp_cuda, adam_cuda)


def launches() -> dict:
    return {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()}


def zero_launches():
    for m in kernel_modules():
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def step_launch_counts(steps: int) -> dict:
    """Every kernel's launches in `steps` stage-1 training steps."""
    return {name: steps * STEP_LAUNCHES.get(name, 0) for name in launches()}


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


def graph_ms(fn, reps: int) -> float:
    """Median device time of `fn` in ms as the training step runs it: one
    call captured as a CUDA graph, its replays timed by `cuda_ms`, so that
    the host's time to launch does not count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def host_probe_ms() -> float:
    """The host's speed, for reading the request latencies (host clocks):
    the median ms of 5 PNG encodes (zlib, on the host's CPU) of one seeded
    640x480 frame, a fixed task whose readings compare across runs."""
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


def wgrad_bytes(n_pad: int, tile_o: int, tile_k: int, splits: int) -> int:
    """Bytes the field's weight-gradient pass moves at `n_pad` rows with dW
    tiles of tile_o outputs x tile_k input columns: each tile reads its
    tile_o columns of the layer's G (2 B each) and its tile_k input columns
    over all rows, and each of the `splits` shares writes its f32 partial of
    the packed weights."""
    from freegaussian_tpu_torch.ops.mlp_cuda import DEPTH, H, layer_k

    total = 0
    for i in range(DEPTH):
        k = layer_k(i)
        total += (k // tile_k) * n_pad * H * 2  # G: all tiles along k, tile_o columns each
        total += (H // tile_o) * n_pad * k * 2  # the input: all tiles along the outputs
        total += splits * H * k * 4
    return total


def field_bwd_parts(kind: str, bwd_fn, bargs, launch_args) -> dict:
    """The field backward's two launches timed apart (CUDA events, median of
    25: the data-gradient walk, then the weight-gradient pass from its G),
    the weight-gradient pass's bytes from its tile sizes (and from the
    parent design's 128 x 32 tiles), and whether two whole backward calls
    give the same bits."""
    import torch

    from freegaussian_tpu_torch.ops import mlp_cuda as mc

    heads, x, dout, wpack, head_w, emb, acts, sources, x_lanes = launch_args
    bufs = mc.bwd_buffers(dout.shape[0], sources, dout.device)
    launch = lambda parts: mc.launch_bwd(heads, x, dout, wpack, head_w, emb, acts, sources, x_lanes, bufs, parts)
    launch(mc.DGRAD_PART | mc.WGRAD_PART)
    first, second = bwd_fn(*bargs), bwd_fn(*bargs)
    torch.cuda.synchronize()
    n_pad = emb.shape[0]
    splits = bufs["partial"].shape[0]
    out = dict(
        dgrad_ms=cuda_ms(lambda: launch(mc.DGRAD_PART), reps=25),
        wgrad_ms=cuda_ms(lambda: launch(mc.WGRAD_PART), reps=25),
        wgrad_bytes=wgrad_bytes(n_pad, mc.H, mc.WGRAD_TILE_K, splits),
        wgrad_bytes_parent_tiles=wgrad_bytes(n_pad, 128, 32, splits),
        bit_equal=all(torch.equal(a, b) for a, b in zip(first, second) if a is not None),
    )
    print(f"kernel {kind} parts " + json.dumps(out))
    if not out["bit_equal"]:
        raise AssertionError(f"{kind}: two backward calls on the same inputs differ")
    return out


# The trainer's shape for the field kernels: the verbs' capacity (2^18
# padded rows) with the bench scene's 1e5 live, at the head and with holes
TRAINER_ROWS = 1 << 18


def trainer_rows(t, n_live: int, seed: int):
    """`t`'s first n_live rows, then stale rows up to TRAINER_ROWS: copies
    of seeded picks of them, as dead slots keep old values."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    pick = torch.randint(0, n_live, (TRAINER_ROWS - n_live,), generator=g).to(t.device)
    return torch.cat([t[:n_live], t[pick]]).contiguous()


def trainer_masks(n_live: int, device) -> dict:
    """The trainer's alive masks over TRAINER_ROWS: "head", the first n_live
    rows (a fresh init); "holed", n_live rows drawn over two of every three
    128-row blocks (the third dead), as refinement leaves them."""
    import torch

    rows = torch.arange(TRAINER_ROWS)
    g = torch.Generator(device="cpu").manual_seed(SEED + 29)
    candidates = torch.nonzero((rows // 128) % 3 != 1)[:, 0]
    holed = torch.zeros(TRAINER_ROWS, dtype=torch.bool)
    holed[candidates[torch.randperm(candidates.shape[0], generator=g)[:n_live]]] = True
    return {"head": (rows < n_live).to(device), "holed": holed.to(device)}


def _check_live_rows(label: str, n_live: int, fwd, plain, bwd, bwd_plain, lead, bargs_of, launch_of, bound,
                     bf16_cot: bool, seed: int) -> dict:
    """One field kernel pair at the trainer's shape (`lead`: the forward's
    leading arguments with TRAINER_ROWS rows; `bargs_of(dout, emb, acts)`
    the backward's arguments, `launch_of(bargs)` `mlp_cuda.launch_bwd`'s
    leading ones) under each of `trainer_masks` (n_live rows): against the
    plain versions with the same mask on the live rows (phase 4's
    budgets), the rows of live blocks bit-equal to the padded call (no
    mask) in the output and dx, zeros on the dead blocks, two calls
    bit-equal; then the ms of the forward (training and serving modes) and
    the backward with the mask, without it (every padded row), the block
    list's own ms and the backward's two launches, beside `bound(n_live,
    backward)`, the least time for the live rows. Returns the lines."""
    import torch

    from freegaussian_tpu_torch.ops import mlp_cuda as mc

    n = lead[0].shape[0]
    out0, (emb0, acts0) = fwd(*lead, True)
    padded = dict(ms=cuda_ms(lambda: fwd(*lead, True), reps=25), serve_ms=cuda_ms(lambda: fwd(*lead, False), reps=25))
    g = torch.Generator(device="cpu").manual_seed(seed)
    cot = torch.randn(out0.shape, generator=g).to(out0.device)
    if bf16_cot:
        cot = cot.bfloat16().float()
    got0 = bwd(*bargs_of(cot, emb0, acts0))
    padded["bwd_ms"] = cuda_ms(lambda: bwd(*bargs_of(cot, emb0, acts0)), reps=25)
    lines = {}
    for name, live in trainer_masks(n_live, out0.device).items():
        blocks = mc.live_blocks(live)
        keep = mc._live_block_rows(live)[:n]
        out, (emb, acts) = fwd(*lead, True, live=live, blocks=blocks)
        again, _ = fwd(*lead, True, live=live, blocks=blocks)
        want, _ = plain(*lead, True, live=live)
        torch.cuda.synchronize()
        mx, nm = _rel_errs(out[live].float(), want[live].float())
        fwd_line = dict(
            max_rel=mx, norm_rel=nm, max_abs_err=float((out[live].float() - want[live].float()).abs().max()),
            live_rows_equal_padded=bool(torch.equal(out[keep], out0[keep])), dead_zero=not bool(out[~keep].any()),
            bit_equal=bool(torch.equal(out, again)), finite=bool(torch.isfinite(out).all()),
            ms=cuda_ms(lambda: fwd(*lead, True, live=live, blocks=blocks), reps=25),
            serve_ms=cuda_ms(lambda: fwd(*lead, False, live=live, blocks=blocks), reps=25),
        )
        fwd_line["bound_ms"], fwd_line["bound_by"] = bound(int(live.sum()), False)
        dout = cot * live[:, None]  # the callers' cotangents are zeros on dead rows
        bargs = bargs_of(dout, emb, acts)
        got = bwd(*bargs, live=live, blocks=blocks)
        got_again = bwd(*bargs, live=live, blocks=blocks)
        want_b = bwd_plain(*bargs, live=live)
        ref = bwd(*bargs_of(dout, emb0, acts0))  # the padded call on the same cotangent
        torch.cuda.synchronize()
        errs = {i: _rel_errs(a, b) for i, (a, b) in enumerate(zip(got, want_b)) if a is not None}
        bwd_line = dict(
            errs=errs, max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want_b) if a is not None),
            errs_vs_padded={i: _rel_errs(a, b) for i, (a, b) in enumerate(zip(got, ref)) if a is not None},
            dx_live_rows_equal_padded=bool(torch.equal(got[0][keep], ref[0][keep])),
            dx_dead_zero=not bool(got[0][~keep].any()),
            bit_equal=all(torch.equal(a, b) for a, b in zip(got, got_again) if a is not None),
            finite=all(bool(torch.isfinite(a).all()) for a in got if a is not None),
            ms=cuda_ms(lambda: bwd(*bargs, live=live, blocks=blocks), reps=25),
        )
        bwd_line["bound_ms"], bwd_line["bound_by"] = bound(int(live.sum()), True)
        largs = launch_of(bargs)
        bufs = mc.bwd_buffers(n, largs[7], dout.device)
        launch = lambda parts: mc.launch_bwd(*largs, bufs, parts, blocks=blocks)
        bwd_line["dgrad_ms"] = cuda_ms(lambda: launch(mc.DGRAD_PART), reps=25)
        bwd_line["wgrad_ms"] = cuda_ms(lambda: launch(mc.WGRAD_PART), reps=25)
        line = dict(rows=n, live=int(live.sum()), live_blocks=int(blocks[-1]), blocks=int(blocks.shape[0] - 1),
                    list_ms=cuda_ms(lambda: mc.live_blocks(live), reps=25), fwd=fwd_line, bwd=bwd_line,
                    padded=padded)
        print(f"kernel {label} live {name} " + json.dumps(line))
        ok = (fwd_line["live_rows_equal_padded"] and fwd_line["dead_zero"] and fwd_line["bit_equal"]
              and fwd_line["finite"] and mx <= DEFORM_OUT_MAX_REL and nm <= DEFORM_OUT_NORM_REL
              and bwd_line["dx_live_rows_equal_padded"] and bwd_line["dx_dead_zero"] and bwd_line["bit_equal"]
              and bwd_line["finite"]
              and all(e[0] <= DEFORM_GRAD_MAX_REL and e[1] <= DEFORM_GRAD_NORM_REL for e in errs.values())
              and all(e[0] <= DEFORM_GRAD_MAX_REL and e[1] <= DEFORM_GRAD_NORM_REL
                      for e in bwd_line["errs_vs_padded"].values()))
        if not ok:
            raise AssertionError(f"{label} live {name}: {line}")
        lines[name] = line
        del out, emb, acts, got, got_again, want_b, ref
    return lines


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

    from freegaussian_tpu_torch.cuda_build import build, ptxas_report

    KERNEL_SOURCES = [name for m in kernel_modules() for name in m.KERNEL_SOURCES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(build, KERNEL_SOURCES))
    for name, done in zip(KERNEL_SOURCES, built):
        print(f"build: {name} ({'already built' if done is None else f'{done[0]:.1f} s'}, sm_90a)")
        for line in ptxas_report(done[1]) if done else ():
            print(f"build: ptxas {name}.cu {line}")
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


def pixel_stage_inputs(model, camera):
    """The pixel stage's inputs (means2d, conics, colors RGB+ED, opacities,
    depths, radii; f32) and the deform field's arguments of `model`'s
    serving frame at `camera`."""
    from freegaussian_tpu_torch.models import fields as fields_mod
    from freegaussian_tpu_torch.ops import rasterize as rasterize_mod

    pixel_stage = rasterize_mod.rasterize_pixels
    field = fields_mod.deform_field
    captured, field_args = [], []

    def capture(*args, **kwargs):
        captured.append(args)
        return pixel_stage(*args, **kwargs)

    def capture_field(*args, **kwargs):
        field_args.append(args)
        return field(*args, **kwargs)

    rasterize_mod.rasterize_pixels = capture
    fields_mod.deform_field = capture_field
    try:
        model(camera)
    finally:
        rasterize_mod.rasterize_pixels = pixel_stage
        fields_mod.deform_field = field
    inputs = tuple(a.float().contiguous() for a in captured[0][:6])
    n = inputs[0].shape[0]
    assert inputs[2].shape == (n, 4), inputs[2].shape  # RGB+ED at serving time
    return inputs, field_args[0]


def _colors(chans, motion, C: int):
    """The compositor's C channels in the model's layouts, from the serving
    frame's RGB+ED and a 2-channel screen motion: ED alone (the cluster
    vote's frame: depth x weight), RGB, RGB+ED, and RGB or RGB+ED with the
    motion (training with the flow losses)."""
    import torch

    layouts = {1: [chans[:, 3:4]], 3: [chans[:, :3]], 4: [chans], 5: [chans[:, :3], motion], 6: [chans, motion]}
    return torch.cat(layouts[C], dim=1).contiguous()


def _check_forward(inputs, width: int, height: int, tiles, channels, frame: str = "bench", timed: bool = True,
                   capacity: int | None = None):
    """The compositor forward (row 1) against its plain version at each tile
    size and channel count: the color within KERNEL_ATOL of its largest
    value, alpha within KERNEL_ATOL, livecnt and t_final bit for bit, and
    two calls bit-equal. `timed` adds the kernel's and the plain version's
    ms and the bound (its pair count from the first tile size's livecnt).
    `capacity` bins into that many slots (padded, or overflowing).
    Returns (rows, that pair count)."""
    import torch

    from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_tiles, rasterize_tiles_plain
    from freegaussian_tpu_torch.ops.tiles import build_intersections

    m2d, con, chans, opac, depths, radii = inputs
    n = m2d.shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 8)
    motion = (torch.randn(n, 2, generator=g) * 2.0).to(m2d.device)
    rows = []
    pairs = None
    for tile in tiles:
        isect = build_intersections(m2d, radii, depths, width, height, tile, capacity)
        for C in channels:
            col = _colors(chans, motion, C)
            args = (m2d, con, col, opac, radii, isect.gauss_ids, isect.tile_offsets, width, height, tile)
            got = rasterize_tiles(*args)
            again = rasterize_tiles(*args)
            torch.cuda.synchronize()
            want = rasterize_tiles_plain(*args)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want) if a.dtype == torch.float32)
            # the color budget scales with the channel's largest value (1 for RGB, the depth for ED)
            color_scale = 1.0 if C > 1 else float(want[0].abs().max())
            color_err = float((got[0] - want[0]).abs().max())
            alpha_err = float((got[1] - want[1]).abs().max())
            over = int(((got[0] - want[0]).abs().amax(-1) > 1e-6 * color_scale).sum())
            live_diff = int((got[2] != want[2]).sum())
            tfinal_diff = int((got[3] != want[3]).sum())
            bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
            if pairs is None:
                pairs = int(got[2].long().sum())
            row = dict(
                frame=frame, width=width, height=height, tile=tile, C=C, num_isects=int(isect.num_isects),
                slots=int(isect.gauss_ids.shape[0]), max_abs_err=err, color_scale=color_scale, color_err=color_err, alpha_err=alpha_err,
                pixels_over_1e6_of_scale=over, livecnt_mismatch=live_diff, t_final_mismatch=tfinal_diff,
                bit_equal=bit_equal,
            )
            if timed:
                row["ms"] = cuda_ms(lambda: rasterize_tiles(*args), reps=25)
                row["plain_ms"] = cuda_ms(lambda: rasterize_tiles_plain(*args), reps=3, warmup=1)
                row["bound_ms"], row["bound_by"] = compositor_bound(n, C, isect.num_isects, isect.num_tiles,
                                                                    width * height, pairs)
            print("kernel rasterize_fwd " + json.dumps(row))
            if not (color_err <= KERNEL_ATOL * color_scale and alpha_err <= KERNEL_ATOL):
                raise AssertionError(f"kernel vs plain at tile {tile}, C={C} ({frame}): color max |diff| {color_err} > "
                                     f"{KERNEL_ATOL} x {color_scale}, or alpha {alpha_err} > {KERNEL_ATOL}")
            if live_diff or tfinal_diff:
                raise AssertionError(f"kernel vs plain at tile {tile}, C={C} ({frame}): livecnt differs at {live_diff} "
                                     f"pixels, t_final at {tfinal_diff}")
            if not bit_equal:
                raise AssertionError(f"rasterize_fwd at tile {tile}, C={C} ({frame}): two calls on the same inputs differ")
            rows.append(row)
    return rows, pairs


def phase_kernels(model) -> dict:
    """Each kernel against its plain version on the main path's inputs."""
    width, height = SERVE_WH
    inputs, field_args = pixel_stage_inputs(model, bench_camera(width, height, DEVICE))
    # 16 first: its livecnt sets the bound's pair count
    rows, pairs16 = _check_forward(inputs, width, height, (16, 32), (1, 3, 4))
    print(f"kernel pairs evaluated (sum of livecnt at tile 16, {width}x{height}): {pairs16}; library_ms: null")
    bwd_rows = _check_backward(*inputs, width, height, pairs16)
    return {
        "rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "bwd_rows": bwd_rows,
        "bwd_max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["walk"] == "rev"),
        "bwd_fwd_max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["walk"] == "fwd"),
        "deform": _check_deform(*field_args),
    }


def _check_deform(x, t_row, ws, bs, head_w, head_b, timed: bool = True) -> dict:
    """The fused deform field's kernels against their plain versions on the
    serving call's inputs (the scene's 100k means, its time row at t = 0.5,
    its weights): the forward in training mode (it also writes the saved
    embedding and activations), then the backward from those same saved
    tensors with a seeded N(0, 1) cotangent on the 13 head lanes. `timed`
    adds the ms, the plain ms, the bounds and the backward's parts."""
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
        )
        if timed:
            fwd.update(
                ms=cuda_ms(lambda: mc.deform_field_fwd(*fargs), reps=25),
                serve_ms=cuda_ms(lambda: mc.deform_field_fwd(*fargs[:-1], False), reps=25),
                plain_ms=cuda_ms(lambda: mc.deform_field_fwd_plain(*fargs), reps=5),
            )
            fwd["bound_ms"], fwd["bound_by"] = field_bound(n, in_ch, True, False, True)
            fwd["serve_bound_ms"], fwd["serve_bound_by"] = field_bound(n, in_ch, False, False, True)
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
        bwd = dict(n=n, errs=errs, max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want)))
        if timed:
            bwd.update(
                ms=cuda_ms(lambda: mc.deform_field_bwd(*bargs), reps=25),
                plain_ms=cuda_ms(lambda: mc.deform_field_bwd_plain(*bargs), reps=5),
            )
            bwd["bound_ms"], bwd["bound_by"] = field_bound(n, in_ch, True, True, True)
            bwd["parts"] = field_bwd_parts("deform_bwd", mc.deform_field_bwd, bargs,
                                           (True, x, dy, fargs[2], fargs[4], emb, acts, 1, x_lanes))
        else:
            bwd["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, mc.deform_field_bwd(*bargs)))
            if not bwd["bit_equal"]:
                raise AssertionError("deform_bwd: two calls on the same inputs differ")
        print("kernel deform_bwd " + json.dumps(bwd))
        for name, (mx, nm) in errs.items():
            if not (mx <= DEFORM_GRAD_MAX_REL and nm <= DEFORM_GRAD_NORM_REL):
                raise AssertionError(f"deform_bwd vs plain, {name}: max rel {mx}, norm rel {nm}")
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError("deform_bwd: non-finite gradients")
    if not timed:
        return {"fwd": fwd, "bwd": bwd}
    big = trainer_rows(x, n, SEED + 31)
    live = _check_live_rows(
        "deform", n, mc.deform_field_fwd, mc.deform_field_fwd_plain, mc.deform_field_bwd, mc.deform_field_bwd_plain,
        (big,) + fargs[1:7], lambda d, e, a: (big, d, fargs[2], fargs[4], e, a, x_lanes),
        lambda b: (True, b[0], b[1], b[2], b[3], b[4], b[5], 1, x_lanes),
        lambda nl, backward: field_bound(nl, in_ch, True, backward, True), False, SEED + 33,
    )
    split = {f"rows_{m.shape[0]}": split_chain_ms(m, t_row, ws, bs, fargs[4], fargs[5]) for m in (x, big)}
    print("kernel deform split-linear chain (cuBLAS, reference) " + json.dumps(split))
    return {"fwd": fwd, "bwd": bwd, "live": live, "split": split}


def split_chain_ms(x, t_row, ws, bs, head_w, head_b) -> dict:
    """The deform field's split-linear chain (`DeformField(impl="split")`,
    bf16: the path of `deform_impl="headsfused"`, cuBLAS products) on the
    same inputs and weights: ms of its forward alone (no gradient) and of
    forward plus backward to every weight with a seeded cotangent; a
    reference reading beside the kernels (no single PyTorch call computes
    the 8-layer trunk)."""
    import torch

    from freegaussian_tpu_torch.models.fields import DeformField

    chain = DeformField(compute_dtype=torch.bfloat16, impl="split").to(x.device)
    with torch.no_grad():
        for layer, w, b in zip(chain.linear, ws, bs):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    params = list(chain.linear.parameters())
    g = torch.Generator(device="cpu").manual_seed(SEED + 37)
    dy = torch.randn(x.shape[0], head_w.shape[0], generator=g).to(x.device)

    def train():
        y = chain._split_forward(x, t_row[None], head_w, head_b)
        torch.autograd.grad(y, params, dy)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: chain._split_forward(x, t_row[None], head_w, head_b), reps=10)
    return {"fwd_ms": fwd_ms, "fwd_bwd_ms": cuda_ms(train, reps=10)}


def _check_backward(m2d, con, chans, opac, depths, radii, width, height, pairs16, frame: str = "bench",
                    tiles=(16, 32), channels=(3, 5), capacity: int | None = None):
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
    row 2's, which reads the forward's own live counts. Another `frame`
    (a capture's own frame shape, with its `tiles` and `channels`) checks
    the reverse walk alone, with no plain time or bound: the same budget,
    and two calls bit-equal. `capacity` bins into that many slots: the
    rows of the padding slots (gauss_ids N) must then be zero."""
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
    bench = frame == "bench"
    frames = [(frame, torch.arange(n, device=m2d.device), tiles, channels)]
    if bench:
        frames.append(("sparse", torch.arange(0, n, 10, device=m2d.device), (16, 32), (5,)))
    for frame, keep, tiles, channels in frames:
        fm2d, fcon, fchans, fopac, fdepths, fradii, fflow = (a[keep].contiguous() for a in (m2d, con, chans, opac, depths, radii, flow))
        for tile in tiles:
            isect = build_intersections(fm2d, fradii, fdepths, width, height, tile, capacity)
            for C in channels:
                col = _colors(fchans, fflow, C)
                fwd_args = (fm2d, fcon, col, fopac, fradii, isect.gauss_ids, isect.tile_offsets)
                color, alpha, livecnt, t_final = rasterize_tiles(*fwd_args, width, height, tile)
                g_color = torch.randn(height, width, C, generator=g).to(m2d.device)
                g_alpha = torch.randn(height, width, generator=g).to(m2d.device)
                r_total = ((color * g_color).sum(-1) + alpha * g_alpha).contiguous()
                kargs = (*fwd_args, livecnt, t_final, g_color, g_alpha, width, height, tile)
                fargs = (*fwd_args, livecnt, r_total, g_color, g_alpha, width, height, tile)
                pargs = (*fwd_args, g_color, g_alpha, width, height, tile)
                got = rasterize_tiles_bwd(*kargs)
                walks = [] if frame == "sparse" else [("rev", got, kargs, rasterize_tiles_bwd)]
                if bench:
                    walks.append(("fwd", rasterize_tiles_bwd_fwd(*fargs), fargs, rasterize_tiles_bwd_fwd))
                torch.cuda.synchronize()
                want = rasterize_tiles_bwd_plain(*pargs)
                torch.cuda.synchronize()
                # the plain backward is autograd over a Python loop (seconds a call): two runs, no warm-up
                p_ms = cuda_ms(lambda: rasterize_tiles_bwd_plain(*pargs), reps=2, warmup=0) if frame == "bench" else None
                bound_ms, bound_by = backward_bound(fm2d.shape[0], C, int(isect.num_isects), isect.num_tiles, width * height, pairs16) if frame == "bench" else (None, None)
                for walk, rows_k, args, fn in walks:
                    name = "rasterize_bwd" if walk == "rev" else "rasterize_bwd_fwd"
                    diff, outside, rel = budget(rows_k, want)
                    row = dict(
                        frame=frame, walk=walk, tile=tile, C=C, num_isects=int(isect.num_isects), elements=rows_k.numel(),
                        max_abs_err=float(diff.max()), max_rel_err_where_above_1e3=rel, outside_budget=outside,
                        outside_share=outside / max(rows_k.numel(), 1), zero_rows=int((rows_k == 0).all(1).sum()),
                        ms=cuda_ms(lambda: fn(*args), reps=25), plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                    )
                    if frame == "bench":
                        row.update(_bwd_parts(name, fwd_args, livecnt, args[8], g_color, g_alpha, width, height, tile, rows_k))
                        if walk == "rev" and tile == 32 and C == 5:
                            row["reduction"] = _reduction_error(rows_k, isect)
                    elif not bench:
                        row.update(width=width, height=height, bit_equal=bool(torch.equal(fn(*args), rows_k)))
                    if capacity is not None:
                        padding = isect.gauss_ids >= fm2d.shape[0]
                        row.update(slots=int(isect.gauss_ids.shape[0]), padding_slots=int(padding.sum()),
                                   nonzero_padding_rows=int((rows_k[padding] != 0).any(1).sum()))
                        if row["nonzero_padding_rows"]:
                            raise AssertionError(f"{name} at capacity {capacity} ({frame}): "
                                                 f"{row['nonzero_padding_rows']} padding rows are not zero")
                    if walk == "fwd":
                        row["max_abs_diff_to_rev_kernel"] = float((rows_k - got).abs().max())
                        row["outside_budget_to_rev_kernel"] = budget(rows_k, got)[1]
                        row["zero_rows_differ_from_rev_kernel"] = int(((rows_k == 0).all(1) != (got == 0).all(1)).sum())
                    print(f"kernel {name} " + json.dumps(row))
                    if not torch.isfinite(rows_k).all():
                        raise AssertionError(f"{name} at tile {tile}, C={C} ({frame}): non-finite rows")
                    if not row.get("bit_equal", True):
                        raise AssertionError(f"{name} at tile {tile}, C={C}: two calls on the same inputs differ")
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


def _reduction_error(rows, isect) -> dict:
    """The per-Gaussian sum of the backward's rows as the step takes it
    (`reduce_rows_by_gid`: an f64 prefix sum over the Gaussian-sorted rows
    and differences at the group boundaries, rounded to f32), and a plain f32 sum
    (`index_add_`), each against a float64 sum of the same rows: the largest
    error, the largest sum, the error relative to its own sum where that sum
    exceeds 1e-3 of the largest, and the normwise error."""
    import torch

    from freegaussian_tpu_torch.ops.rasterize_cuda import reduce_rows_by_gid

    ids = isect.gauss_ids.long()
    n = int(isect.counts.shape[0])
    ref = torch.zeros((n, rows.shape[1]), dtype=torch.float64, device=rows.device).index_add_(0, ids, rows.double())
    scale = ref.abs()
    above = scale > 1e-3 * float(scale.max())
    out = {"num_isects": int(ids.shape[0]), "max_abs_f64": float(scale.max())}
    sums = {
        "prefix": reduce_rows_by_gid(rows, isect.gauss_ids, isect.offsets, isect.counts),
        "index_add_f32": torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=rows.device).index_add_(0, ids, rows),
    }
    for name, got in sums.items():
        diff = (got.double() - ref).abs()
        out[name] = {
            "max_abs_err": float(diff.max()), "max_rel_err_where_above_1e-3": float((diff / scale)[above].max()),
            "norm_rel_err": float(diff.norm() / ref.norm()),
        }
    print("reduction (tile 32, C 5, bench frame) " + json.dumps(out))
    return out


def _bwd_parts(name, fwd_args, livecnt, pixel_in, g_color, g_alpha, width, height, tile, rows_k) -> dict:
    """The compositor backward's two launches timed apart (CUDA events,
    median of 25: the quadrant walk into the scratch, then the combine into
    the rows), the scratch's size, and whether a second call on the same
    inputs gives `rows_k`'s bits."""
    import torch

    from freegaussian_tpu_torch.ops import rasterize_cuda as rc

    rows, scratch = rc.bwd_buffers(rows_k.shape[0], rows_k.shape[1] - rc.GRAD_ROW_HEAD, tile, rows_k.device)
    launch = lambda parts: rc.launch_bwd(name, *fwd_args, livecnt, pixel_in, g_color, g_alpha, width, height, tile,
                                         rows, scratch, parts)
    launch(rc.BWD_WALK_PART | rc.BWD_COMBINE_PART)
    torch.cuda.synchronize()
    return dict(
        walk_ms=cuda_ms(lambda: launch(rc.BWD_WALK_PART), reps=25),
        combine_ms=cuda_ms(lambda: launch(rc.BWD_COMBINE_PART), reps=25),
        scratch_bytes=scratch.numel() * 4, bit_equal=bool(torch.equal(rows, rows_k)),
    )


def query(views, i, atrb=None) -> str:
    """The GET /render path of view i, with the attribute sliders `atrb`."""
    th, ph, r, t = views[i]
    q = f"/render?th={th}&ph={ph}&r={r}&t={t}"
    return q if atrb is None else q + "&atrb=" + ",".join(f"{v:g}" for v in np.ravel(atrb))


def check_frame(status, ctype, body, width: int, height: int, min_colors: int = 100) -> np.ndarray:
    """A /render answer: 200, image/jpeg, a JPEG of the frame's size that
    is not a constant frame (more than `min_colors` distinct colors).
    Returns the decoded (H, W, 3) uint8 frame."""
    import io

    from PIL import Image

    assert status == 200 and ctype == "image/jpeg", (status, ctype)
    img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    assert img.shape == (height, width, 3), img.shape
    colors = len(np.unique(img.reshape(-1, 3), axis=0))
    assert img.std() > 1.0 and colors > min_colors, f"constant frame: std {img.std()}, {colors} colors"
    return img


def _serve(render_fn, width: int, height: int, views, label: str, per_request: dict, num_attributes: int = 0,
           atrbs=None):
    """Start a viewer over `render_fn`, GET /render for each view (with the
    attribute sliders `atrbs[i]` when given), check every answer, shut it
    down. The launch counts are zeroed just before the requests and read
    just after; each request must launch `per_request` (kernel name ->
    count) and nothing else. With sliders, one more request (after the
    counts are read) at the first view with the sliders at zero must give
    another frame. Returns (request latencies in ms, launches)."""
    from freegaussian_tpu_torch.viewer.server import ViewerServer

    def get_frame(path):
        """(frame, JPEG bytes, the request's ms: to its last byte, before the decode)."""
        t0 = time.perf_counter()
        status, ctype, body = http_get(server.port, path)
        ms = (time.perf_counter() - t0) * 1e3
        return check_frame(status, ctype, body, width, height), len(body), ms

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
            img, size, ms = get_frame(query(views, i, None if atrbs is None else atrbs[i]))
            launched = sum(launches().values()) - before
            assert launched == sum(per_request.values()), f"{launched} kernel launches for one request, want {per_request}"
            latencies.append(ms)
            frames.append(img)
            print(f"serve {label} {width}x{height} {query(views, i, None if atrbs is None else atrbs[i])}: 200 image/jpeg {size} B in {ms:.1f} ms")
        counts = launches()
        if atrbs is not None:
            still = get_frame(query(views, 0, np.zeros_like(atrbs[0])))[0]
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


def build_train_case(model, width: int, height: int, device=None, flow_3d: bool = True, extras: bool | dict = False):
    """The training phase's inputs, from the loaded bench scene: a trainable
    copy of its parameters and deform field (bf16 trunk), the training
    config (tile 32, warm-up 0, black background, configs/sim/base.yaml's
    flow weights), the bench camera at t = 0.5 and its paired camera at
    t = 0.4, and seeded synthetic targets: the image is the scene rendered
    with its SH DC colors shifted by N(0, 0.3) noise, depth0 the scene's
    expected depth from the paired camera, the flow a constant (0.8, -0.5) px
    motion plus N(0, 0.3) noise. With `extras` (`train_case_config`) the
    state holds camera 0's pose adjustment and its bilateral grid (seeded:
    adjustments N(0, 0.01), grid identity + N(0, 0.02)), which the step
    optimizes and applies where the config enables them. Returns (state,
    step_fn, camera, camera0, batch)."""
    import copy
    import dataclasses

    import torch

    from freegaussian_tpu_torch.engine.train_step import create_train_state, make_train_step
    from freegaussian_tpu_torch.models.bilagrid import init_bilateral_grids
    from freegaussian_tpu_torch.models.splat_model import forward

    device = device or DEVICE
    cfg, optimizers, densify_cfg = train_case_config(model, flow_3d=flow_3d, extras=extras)
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
    extra_tensors = {}
    if extras:
        # one camera's seeded adjustment and grid, so both change the frame
        ge = torch.Generator(device="cpu").manual_seed(SEED + 71)
        extra_tensors = dict(
            camera_opt=(0.01 * torch.randn(1, 6, generator=ge)).to(device),
            bilagrid=(init_bilateral_grids(1, device="cpu") + 0.02 * torch.randn(1, 8, 16, 16, 12, generator=ge)).to(device),
        )
    state = create_train_state(params, alive, deform, optimizers, generator=torch.Generator(device=device).manual_seed(SEED),
                               **extra_tensors)
    step_fn = make_train_step(cfg, densify_cfg, optimizers, num_train_data=0)
    return state, step_fn, camera, camera0, batch


def train_case_config(model, flow_3d: bool = True, extras: bool | dict = False):
    """The training phases' (SplatConfig, optimizers, DensifyConfig); with
    `extras`, camera optimization (SO3xR3) and the bilateral grid on (True),
    or the SplatConfig fields of a dict set."""
    import dataclasses

    from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
    from freegaussian_tpu_torch.models.densify import DensifyConfig
    from freegaussian_tpu_torch.models.splat_model import SplatConfig

    cfg = dataclasses.replace(SplatConfig(**TRAIN_MODEL), deform_bf16=model.cfg.deform_bf16)
    if not flow_3d:
        cfg = dataclasses.replace(cfg, flow_3d_loss_weight=0.0)
    if extras:
        cfg = dataclasses.replace(cfg, **(EXTRAS_MODEL if extras is True else extras))
    return cfg, make_optimizers(OptimizersConfig()), DensifyConfig(**TRAIN_DENSIFY)


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
    want = step_launch_counts(TRAIN_STEPS)
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

    def capture(*args, **kwargs):
        calls.append(args)
        return trunk(*args, **kwargs)

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
        bwd["parts"] = field_bwd_parts(f"field_bwd ({mode})", mc.field_trunk_bwd, bargs,
                                       (False, xsrc, dh, wpack, None, emb, acts, sources, x_lanes))
        print("kernel field_bwd " + json.dumps(bwd))
        for name, (emx, enm) in errs.items():
            if not (emx <= DEFORM_GRAD_MAX_REL and enm <= DEFORM_GRAD_NORM_REL):
                raise AssertionError(f"field_bwd ({mode}) vs plain, {name}: max rel {emx}, norm rel {enm}")
        if not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"field_bwd ({mode}): non-finite gradients")
        big = trainer_rows(xsrc, n, SEED + 41)
        live = _check_live_rows(
            f"field ({mode})", n, mc.field_trunk_fwd, mc.field_trunk_fwd_plain, mc.field_trunk_bwd,
            mc.field_trunk_bwd_plain, (big,) + fargs[1:], lambda d, e, a: (big, d, wpack, e, a, sources, x_lanes),
            lambda b: (False, b[0], b[1], b[2], None, b[3], b[4], sources, x_lanes),
            lambda nl, backward: field_bound(nl, in_ch, True, backward, False, sources), True, SEED + 43,
        )
    return {"fwd": fwd, "bwd": bwd, "live": live}


SERVE2_REPEATS = 3


def phase_serve2(model2) -> dict:
    """The stage-2 serving path: the slider viewer over the stage-2 model at
    640x480 (tile 32), GET /render with non-zero sliders; each request runs
    the control trunk and the compositor once. SERVE2_REPEATS servers in a
    row, each with its host probe (one earlier run read 554-620 ms requests
    here, which no later run has shown). Launches: the first server's."""
    from freegaussian_tpu_torch.viewer.server import control_render_fn

    w, h = SERVE_WH
    runs = []
    for rep in range(SERVE2_REPEATS):
        lat, counts = _serve(
            control_render_fn(model2), w, h, VIEWS, "stage2", {"rasterize_fwd": 1, "field_fwd": 1},
            num_attributes=model2.num_attributes, atrbs=SLIDERS,
        )
        runs.append((lat, counts))
        print(
            f"serve stage2 ({w}x{h} tile {model2.cfg.tile_size}, sliders) run {rep}: {len(lat)} requests, launches "
            f"{json.dumps(counts)}, latency first {lat[0]:.1f} ms, median of the rest {statistics.median(lat[1:]):.1f} ms, "
            f"max {max(lat):.1f} ms"
        )
    return {"latency_ms": [lat for lat, _ in runs], "launches": runs[0][1]}


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
    per_step = {"field_fwd": 3, "field_bwd": 1, "rasterize_fwd": 1, "rasterize_bwd": 1, "adam": 1}
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
    for name in ("rasterize_fwd", "rasterize_bwd", "deform_fwd", "deform_bwd", "adam"):
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
    return {"trainer": trainer, "ckpt": ckpt, "over": over, "launches": counts, "median_step_ms": steady, "losses": losses}


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
    for name in ("field_fwd", "field_bwd", "rasterize_fwd", "rasterize_bwd", "adam"):
        if not counts[name] > 0:
            raise AssertionError(f"train-control verb launched {name} {counts[name]} times")
    return {"trainer": ctrainer, "ckpt": out / "freegaussian" / "checkpoints", "over": over, "mask": mask_path,
            "launches": counts, "median_step_ms": statistics.median(step_ms[DATA_FRAMES:])}


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

    inp, wpack, bias = calls[0][:3]
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
        bwd["parts"] = field_bwd_parts("trunk_bwd", mc.trunk_bwd, (dh, wpack, emb, acts),
                                       (False, None, dh, wpack, None, emb, acts, 0, 0))
        print("kernel trunk_bwd " + json.dumps(bwd))
        for name, (emx, enm) in errs.items():
            if not (emx <= DEFORM_GRAD_MAX_REL and enm <= DEFORM_GRAD_NORM_REL):
                raise AssertionError(f"trunk_bwd vs plain, {name}: max rel {emx}, norm rel {enm}")
        if bwd["d_emb_nonzero_past_fan_in"] or not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"trunk_bwd: {bwd['d_emb_nonzero_past_fan_in']} non-zero lanes past the fan-in, or non-finite")
        big = trainer_rows(inp, n, SEED + 47)
        live = _check_live_rows(
            "trunk", n, mc.trunk_fwd, mc.trunk_fwd_plain, mc.trunk_bwd, mc.trunk_bwd_plain, (big, wpack, bias),
            lambda d, e, a: (d, wpack, e, a), lambda b: (False, None, b[0], b[1], None, b[2], b[3], 0, 0),
            lambda nl, backward: trunk_bound(nl, in_ch, True, backward), True, SEED + 49,
        )
    return {"launches": counts, "fwd": fwd, "bwd": bwd, "live": live}


def phase_viewer_verb(data: Path, verb: dict, control_verb: dict) -> dict:
    """The `viewer` verb in process (`cli.serve_viewer`, what `cli.main`
    runs before it waits) over the `train` verb's checkpoint directory
    (stage 1: --data --load) and the `train-control` verb's (stage 2:
    --stage1-checkpoint --gaussian-mask --load, deform_impl "pallas"), each
    with its verb's config overlay and capacity, at 640x480: the served
    state is the verb's last step; every GET /render answers image/jpeg,
    the last one the JPEG of the trainer's own frame for that camera (stage
    2: at the request's sliders); each request launches the field forward
    and the compositor once (the launch counts zeroed just before the
    route's requests and read just after)."""
    import torch

    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.engine import checkpoints
    from freegaussian_tpu_torch.viewer.server import encode_jpeg, orbit_camera, to_rgb8

    w, h = SERVE_WH
    views = VIEWS[:3]
    routes = {
        "stage1": (["--config", HERE / "configs/sim/base.yaml", "--scene-config", verb["over"], "--load", verb["ckpt"]],
                   verb["ckpt"], {"deform_fwd": 1, "rasterize_fwd": 1}, None),
        "stage2": (["--config", HERE / "configs/control/sim/base.yaml", "--scene-config", control_verb["over"],
                    "--stage1-checkpoint", verb["ckpt"], "--gaussian-mask", control_verb["mask"], "--load",
                    control_verb["ckpt"], "--deform-impl", STAGE2_IMPL],
                   control_verb["ckpt"], {"field_fwd": 1, "rasterize_fwd": 1}, SLIDERS),
    }
    out = {}
    for route, (flags, ckpt, per_request, atrbs) in routes.items():
        saved = checkpoints.read_checkpoint(ckpt)  # the directory's latest step
        argv = ["viewer", "--data", data, *flags, "--capacity", VERB_CAPACITY, "--device", DEVICE, "--host",
                "127.0.0.1", "--port", 0, "--width", w, "--height", h]
        args = cli.build_parser().parse_args([str(a) for a in argv])
        t0 = time.perf_counter()
        trainer, server = cli.serve_viewer(args)
        setup_s = time.perf_counter() - t0
        try:
            if cli.viewer_route(args) != route or int(trainer.state.step) != saved["step"]:
                raise AssertionError(f"viewer verb ({route}): serves step {int(trainer.state.step)}, the verb's last "
                                     f"step is {saved['step']}")
            served = checkpoints.state_dict(trainer.state)
            for group in ("params", "control") if route == "stage2" else ("params",):
                for k, v in saved[group].items():
                    if not torch.equal(served[group][k], v):
                        raise AssertionError(f"viewer verb ({route}): the served {group}.{k} is not the checkpoint's")
            torch.cuda.synchronize()
            zero_launches()
            latencies = []
            for i in range(len(views)):
                atrb = None if atrbs is None else atrbs[i]
                t0 = time.perf_counter()
                status, ctype, body = http_get(server.port, query(views, i, atrb))
                latencies.append((time.perf_counter() - t0) * 1e3)
                check_frame(status, ctype, body, w, h, min_colors=1)
            counts = launches()
            th, ph, r, t = views[-1]
            cam = orbit_camera(th, ph, r, width=w, height=h, time=t, device=DEVICE)
            frame = trainer._render_rgb(cam) if atrbs is None else trainer.render_with_control(cam, 0.1 * atrbs[len(views) - 1])["rgb"]
            same = body == encode_jpeg(to_rgb8(frame))
        finally:
            server.shutdown()
        print(f"viewer verb {route}: built and loaded in {setup_s:.1f} s, step {int(trainer.state.step)}; "
              f"{len(views)} requests {w}x{h} image/jpeg, latency ms {[round(v, 1) for v in latencies]}; launches "
              f"{json.dumps(counts)}; the last answer is the JPEG of the trainer's own frame: {same}")
        want_counts = {name: len(views) * per_request.get(name, 0) for name in counts}
        if counts != want_counts:
            raise AssertionError(f"viewer verb ({route}): launches {counts}, want {want_counts}")
        if not same:
            raise AssertionError(f"viewer verb ({route}): the answer is not the JPEG of the trainer's frame")
        out[route] = {"launches": counts, "latency_ms": latencies, "setup_s": setup_s}
    return out


# ---------------------------------------------------------------------------
# slice 7: the cluster, eval, render and export verbs
# ---------------------------------------------------------------------------

PIPELINE_CONTROL_STEPS = 5
DYNAMIC_KEY_FRAMES = [0, 1, 2, 4, 5, 7]
ORBIT_FRAMES = 8
# the vote by the kernels against the vote by the plain compositor: rows that
# may differ (a center pixel's expected depth on a window edge within f32
# rounding), as a share of the live rows
CLUSTER_MAX_DIFF = 1e-3
LPIPS_RTOL = 1e-4  # LPIPS on the card against the CPU's, same frames and weights
EXPORT_ATOL = 1e-6  # the exported checkpoint's frame against the trainer's
EVAL_MIN_PSNR = 25.0  # stage-1 eval of the bench scene against the dataset rendered from it


@contextlib.contextmanager
def lpips_weights_env(path: Path):
    """FREEGAUSSIAN_LPIPS_WEIGHTS set to `path` inside the block, then set
    back to what it was (or unset): `eval_all` takes its per-frame loop
    while LPIPS weights load, and the sweep otherwise."""
    import os

    name = "FREEGAUSSIAN_LPIPS_WEIGHTS"
    before = os.environ.get(name)
    os.environ[name] = str(path)
    try:
        yield
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before


def seeded_lpips_weights(path: Path, seed: int = SEED + 61) -> Path:
    """Seeded AlexNet-LPIPS weights in the npz layout `models/metrics.py`
    reads: conv weights N(0, 1 / fan_in), biases N(0, 0.05^2), calibration
    U(0, 0.2). Not pretrained: the LPIPS they give is no quality number."""
    from freegaussian_tpu_torch.models.metrics import ALEX_CONVS

    rng = np.random.default_rng(seed)
    weights, in_ch = {}, 3
    for i, (out_ch, k, _, _) in enumerate(ALEX_CONVS):
        weights[f"conv{i}_w"] = rng.normal(scale=1.0 / np.sqrt(in_ch * k * k), size=(out_ch, in_ch, k, k)).astype(np.float32)
        weights[f"conv{i}_b"] = rng.normal(scale=0.05, size=(out_ch,)).astype(np.float32)
        weights[f"lin{i}"] = rng.uniform(0, 0.2, size=(out_ch,)).astype(np.float32)
        in_ch = out_ch
    np.savez(path, **weights)
    return path


def bench_scene_checkpoint(trainer, model, dest: Path, transform=None, scale: float = 1.0) -> Path:
    """The bench scene (phase 3's model: its Gaussians and deform field, at
    its step) moved into the dataset's frame by the dataparser's orient and
    center transform (`transform`, by default the trainer's) and scale
    (means times `scale`, log scales plus log `scale`), written through the
    verb's trainer state (capacity VERB_CAPACITY) as a checkpoint directory
    of the port. Its scales are isotropic, so its rotations need no
    turning; the deform field and the SH colors stay as they were. Phase 13
    rendered the dataset from this scene, so the cluster vote finds it in
    front of the cameras, where the train verb's 30 steps from random
    Gaussians leave the vote all but empty."""
    import torch

    from freegaussian_tpu_torch.engine.checkpoints import save_checkpoint

    T = torch.as_tensor(trainer.parsed.dataparser_transform if transform is None else transform, device=DEVICE)
    st = trainer.state
    n = int(model.alive.shape[0])
    with torch.no_grad():
        for name, p in st.params.items():
            src = model.params[name]
            if name == "means":
                src = (src @ T[:, :3].T + T[:, 3]) * scale
            elif name == "scales":
                src = src + float(np.log(scale))
            p.zero_()
            p[:n] = src
        st.alive.zero_()
        st.alive[:n] = model.alive
        st.deform.load_state_dict(model.deform.state_dict())
    st.step = model.step
    save_checkpoint(dest, model.step, st)
    return dest


def _run_verb(argv) -> dict:
    """`cli.main(argv)` in process, the launch counts zeroed just before and
    read just after; the channel count of every compositor call, the set of
    (walk, C, width, height, tile) of its forward ("fwd") and backward
    ("bwd") calls, and the verb's setup seconds (building its trainer and
    loading the checkpoint) apart from its work seconds (synced host
    clocks)."""
    import torch

    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.ops import rasterize_cuda

    real_build, real_tiles, real_bwd = cli._build_trainer, rasterize_cuda.rasterize_tiles, rasterize_cuda.rasterize_tiles_bwd
    setup, channels, shapes = [], [], set()

    def build(*args, **kwargs):
        t0 = time.perf_counter()
        trainer = real_build(*args, **kwargs)
        torch.cuda.synchronize()
        setup.append(time.perf_counter() - t0)
        return trainer

    def tiles(*args, **kwargs):
        channels.append(int(args[2].shape[1]))
        shapes.add(("fwd", int(args[2].shape[1]), *args[7:10]))
        return real_tiles(*args, **kwargs)

    def bwd(*args, **kwargs):
        shapes.add(("bwd", int(args[2].shape[1]), *args[11:14]))
        return real_bwd(*args, **kwargs)

    cli._build_trainer, rasterize_cuda.rasterize_tiles, rasterize_cuda.rasterize_tiles_bwd = build, tiles, bwd
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    try:
        trainer = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
    finally:
        cli._build_trainer, rasterize_cuda.rasterize_tiles, rasterize_cuda.rasterize_tiles_bwd = real_build, real_tiles, real_bwd
    wall = time.perf_counter() - t0
    return {"trainer": trainer, "launches": launches(), "channels": channels, "shapes": shapes, "setup_s": setup[0],
            "work_s": wall - setup[0]}


def _want_launches(**counts) -> dict:
    return {name: counts.get(name, 0) for name in launches()}


def _check_launches(label: str, run: dict, want: dict, channels: dict):
    seen = {c: run["channels"].count(c) for c in sorted(set(run["channels"]))}
    print(f"pipeline {label}: setup {run['setup_s']:.1f} s, work {run['work_s']:.2f} s; launches "
          f"{json.dumps(run['launches'])}; compositor channels {json.dumps(seen)}")
    if run["launches"] != want or seen != channels:
        raise AssertionError(f"pipeline {label}: launches {run['launches']}, want {want}; channels {seen}, want {channels}")


def phase_pipeline(tmp: Path, data: Path, verb: dict, model, card: str) -> dict:
    """The cluster, train-control, eval, render and export verbs in process
    (`cli.main`) over the dataset and the bench scene's checkpoint directory
    (`bench_scene_checkpoint`, written through the `train` verb's state),
    with the train verb's config overlay; the launch counts zeroed just
    before each verb and read just after (see the module docstring, phase
    19)."""
    import torch

    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.data.splat_export import import_splat_ply
    from freegaussian_tpu_torch.models.metrics import lpips
    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint
    from freegaussian_tpu_torch.ops import rasterize_cuda
    from freegaussian_tpu_torch.preprocess.clustering import cluster_gaussians

    out = tmp / "pipeline"
    out.mkdir()
    n_frames = DATA_FRAMES
    ckpt = bench_scene_checkpoint(verb["trainer"], model, out / "bench_checkpoints")
    # where a verb's setup goes: the dataset's parse, and the random init that
    # the trainer builds (its 3-NN distances) before the checkpoint replaces it
    from freegaussian_tpu_torch.engine.trainer import _parse_splits
    from freegaussian_tpu_torch.models.gaussians import init_gaussians

    cfg = verb["trainer"].config
    t0 = time.perf_counter()
    _parse_splits(cfg)
    parse_s = time.perf_counter() - t0
    n_init = min(cfg.num_random, cfg.capacity // 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init_gaussians(cfg.capacity, generator=torch.Generator(device=DEVICE).manual_seed(SEED), num_random=n_init,
                   sh_degree=cfg.splat.sh_degree, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"pipeline setup parts: the dataset's parse (train and val splits) {parse_s:.2f} s, the random init of "
          f"{n_init} Gaussians {init_s:.2f} s ({card})")
    stage1 = ["--data", data, "--config", HERE / "configs/sim/base.yaml", "--scene-config", verb["over"],
              "--load", ckpt, "--capacity", VERB_CAPACITY, "--device", DEVICE]
    total = dict.fromkeys(launches(), 0)
    result = {"parse_s": parse_s, "init_s": init_s}

    def add(run):
        for k, v in run["launches"].items():
            total[k] += v

    # 1. cluster: static over every frame (the default output in the dataset
    # directory), --dynamic over DYNAMIC_KEY_FRAMES; each vote held against
    # the vote by the plain compositor on the same inputs
    key_frames = out / "key_frames.yaml"
    key_frames.write_text(f"bench: {{frames: {DYNAMIC_KEY_FRAMES}}}\n")
    static_mask = None
    for label, flags, frames, deform_launches in (
        ("cluster", [], list(range(n_frames)), 0),
        ("cluster --dynamic", ["--dynamic", "--key-frames", key_frames, "--scene", "bench", "--out",
                               out / "gaussian_mask_dynamic.npy"], DYNAMIC_KEY_FRAMES, 1),
    ):
        run = _run_verb(["cluster", *stage1, *flags])
        add(run)
        k = len(frames)
        _check_launches(label, run, _want_launches(rasterize_fwd=k, deform_fwd=deform_launches * k), {1: k})
        trainer = run["trainer"]
        st = trainer.state
        mask_path = data / f"gaussian_mask_{int(st.alive.sum())}x2.npy" if not flags else out / "gaussian_mask_dynamic.npy"
        static_mask = static_mask if flags else mask_path
        got = np.load(mask_path)
        if got.shape != (int(st.alive.sum()), 2) or not mask_path.with_suffix(".ply").exists():
            raise AssertionError(f"pipeline {label}: mask {got.shape} at {mask_path}, live {int(st.alive.sum())}")
        masks, cameras, valids = cli.cluster_inputs(trainer, *((str(key_frames), "bench") if flags else ()))
        real_tiles = rasterize_cuda.rasterize_tiles
        rasterize_cuda.rasterize_tiles = rasterize_cuda.rasterize_tiles_plain
        try:
            plain = cluster_gaussians(st.params, st.alive, masks, cameras, deform=st.deform if flags else None,
                                      mask_valids=valids or None)[st.alive].cpu().numpy()
        finally:
            rasterize_cuda.rasterize_tiles = real_tiles
        differ = int((got != plain).any(-1).sum())
        ms_per_frame = run["work_s"] / k * 1e3
        print(f"pipeline {label}: mask {got.shape}, rows voted {int(got.any(-1).sum())} ({got.any(-1).mean():.2%}), "
              f"votes per attribute {got.sum(0).tolist()}; against the plain compositor's vote {differ} rows differ "
              f"({differ / got.shape[0]:.4%}); {ms_per_frame:.1f} ms per key frame ({card})")
        if differ > CLUSTER_MAX_DIFF * got.shape[0] or not got.any():
            raise AssertionError(f"pipeline {label}: {differ} of {got.shape[0]} rows differ from the plain vote, "
                                 f"or no votes")
        result[label] = {"ms_per_key_frame": ms_per_frame, "differ": differ, "setup_s": run["setup_s"],
                         "work_s": run["work_s"]}
        del trainer, st, run

    # 2. train-control on the cluster verb's own mask
    control_out = out / "control_out"
    over2 = out / "control_over.yaml"
    over2.write_text(f"max_num_iterations: {PIPELINE_CONTROL_STEPS}\nsteps_per_log: 1\noutput_dir: {control_out}\n")
    stage2 = ["--data", data, "--config", HERE / "configs/control/sim/base.yaml", "--scene-config", over2,
              "--stage1-checkpoint", ckpt, "--gaussian-mask", static_mask, "--deform-impl", STAGE2_IMPL,
              "--capacity", VERB_CAPACITY, "--device", DEVICE]
    run = _run_verb(["train-control", *stage2])
    add(run)
    rows, _ = _verb_metrics(control_out)
    losses = [r["loss"] for r in rows]
    ctrainer = run["trainer"]
    same_mask = np.array_equal(ctrainer.gaussian_mask[ctrainer.state.alive].cpu().numpy(), np.load(static_mask))
    print(f"pipeline train-control: {PIPELINE_CONTROL_STEPS} steps on the cluster verb's mask (the same rows: "
          f"{same_mask}), setup {run['setup_s']:.1f} s, work {run['work_s']:.2f} s; loss {losses}; launches "
          f"{json.dumps(run['launches'])}")
    if len(losses) != PIPELINE_CONTROL_STEPS or not all(np.isfinite(v) for v in losses) or not same_mask:
        raise AssertionError(f"pipeline train-control: losses {losses}, mask rows equal {same_mask}")
    del ctrainer, run

    # 3. eval, stage 1 and stage 2, with LPIPS from seeded weights; the
    # variable is restored after, so later evals take the sweep
    with lpips_weights_env(seeded_lpips_weights(out / "lpips_seeded.npz")):
        for label, flags, want in (
            ("eval stage 1", stage1, _want_launches(rasterize_fwd=n_frames, deform_fwd=n_frames)),
            # stage 2: the control state (the deform trunk at the init time and the frame's) and the control trunk
            ("eval stage 2", [*stage2, "--load", control_out / "freegaussian" / "checkpoints"],
             _want_launches(rasterize_fwd=n_frames, field_fwd=3 * n_frames)),
        ):
            tag = label.replace(" ", "_")
            run = _run_verb(["eval", *flags, "--dump-images", out / f"{tag}_dump", "--report", out / f"{tag}.json"])
            add(run)
            _check_launches(label, run, want, {4: n_frames})  # the serving forward renders RGB+ED
            report = json.loads((out / f"{tag}.json").read_text())
            trainer = run["trainer"]
            with torch.no_grad():
                frames = [(trainer._render_rgb(cam), batch["image"][..., :3]) for cam, batch in trainer.datamanager.eval_frames()]
                card_lp = [lpips(a, b) for a, b in frames]
                cpu_lp = [lpips(a.cpu(), b.cpu()) for a, b in frames]
            rel = max(abs(a - b) / abs(b) for a, b in zip(card_lp, cpu_lp))
            mean_rel = abs(report["lpips"] - float(np.mean(cpu_lp))) / abs(float(np.mean(cpu_lp)))
            dumps = len(list((out / f"{tag}_dump").glob("eval_*.png")))
            print(f"pipeline {label}: psnr {report['psnr']:.4f}, ssim {report['ssim']:.4f}, lpips (seeded weights, not a "
                  f"quality number) {report['lpips']:.6f} against the CPU's {np.mean(cpu_lp):.6f} (relative {mean_rel:.2e}; "
                  f"per frame up to {rel:.2e}), {dumps} dumps; {report['fps']:.2f} eval fps at {SERVE_WH[0]}x{SERVE_WH[1]} "
                  f"({card})")
            # stage 1 renders the scene the dataset was rendered from (in its frame, the deform field and SH as they were)
            min_psnr = EVAL_MIN_PSNR if label == "eval stage 1" else -np.inf
            if not (report["psnr"] >= min_psnr and np.isfinite(report["ssim"]) and report["lpips_available"]
                    and rel <= LPIPS_RTOL and mean_rel <= LPIPS_RTOL and dumps == n_frames):
                raise AssertionError(f"pipeline {label}: report {report}, LPIPS relative {rel} / {mean_rel}, dumps {dumps}")
            # the same sweep without the PNG dumps, on the same trainer (its frames already on the card)
            bare = trainer.eval_all()
            print(f"pipeline {label}: {bare['fps']:.2f} eval fps without --dump-images, the frames on the card ({card})")
            result[label] = {"fps": report["fps"], "fps_no_dumps": bare["fps"], "setup_s": run["setup_s"],
                             "work_s": run["work_s"]}
            del trainer, run, frames

    # 4. render: the dataset's cameras and an orbit; rgb at C = 3, depth at C = 4
    for label, flags, k in (("render dataset", [], n_frames),
                            ("render orbit", ["--path", "orbit", "--num-frames", ORBIT_FRAMES], ORBIT_FRAMES)):
        dest = out / label.replace(" ", "_")
        run = _run_verb(["render", *stage1, "--out", dest, *flags])
        add(run)
        _check_launches(label, run, _want_launches(rasterize_fwd=2 * k, deform_fwd=2 * k), {3: k, 4: k})
        pngs, npys = len(list((dest / "rgb").glob("*.png"))), list((dest / "depth").glob("*.npy"))
        depth = np.load(npys[0]) if npys else None
        ms = run["work_s"] / k * 1e3
        print(f"pipeline {label}: {pngs} PNGs, {len(npys)} depth npys {None if depth is None else depth.shape}; "
              f"{ms:.1f} ms per frame, rgb and depth, with the files ({card})")
        if pngs != k or len(npys) != k or depth.shape != (SERVE_WH[1], SERVE_WH[0]) or not np.isfinite(depth).all():
            raise AssertionError(f"pipeline {label}: {pngs} PNGs, {len(npys)} npys")
        result[label] = {"ms_per_frame": ms, "setup_s": run["setup_s"], "work_s": run["work_s"]}
        del run

    # 5. export: the PLY reads back as the live parameters; the reference
    # checkpoint, loaded by the port, renders the trainer's own frame
    run = _run_verb(["export", *stage1, "--out", out / "scene.ply"])
    add(run)
    st = run["trainer"].state
    params, n = import_splat_ply(out / "scene.ply")
    ply_equal = n == int(st.alive.sum()) and all(
        torch.equal(params[k], st.params[k].detach()[st.alive].cpu()) for k in params)
    print(f"pipeline export ply: {n} Gaussians, setup {run['setup_s']:.1f} s, work {run['work_s']:.2f} s; "
          f"import_splat_ply equals the live parameters: {ply_equal}")
    if not ply_equal:
        raise AssertionError("pipeline export ply: the PLY does not read back as the live parameters")
    run = _run_verb(["export", *stage1, "--format", "torch", "--out", out / "scene.ckpt"])
    add(run)
    trainer = run["trainer"]
    model = load_reference_checkpoint(out / "scene.ckpt", cfg=trainer.config.splat, device=DEVICE)
    cam = trainer.datamanager.frames[3].camera
    diff = float((model(cam)["rgb"] - trainer._render_rgb(cam)).abs().max())
    print(f"pipeline export torch: step {model.step}, {int(model.alive.sum())} Gaussians, setup {run['setup_s']:.1f} s, "
          f"work {run['work_s']:.2f} s; its frame against the trainer's: max |diff| {diff:.3g}")
    if diff > EXPORT_ATOL or model.step != int(trainer.state.step):
        raise AssertionError(f"pipeline export torch: frame max |diff| {diff}, step {model.step}")
    print(f"pipeline launches: {json.dumps(total)}")
    return {"launches": total, **result}


# Phase 20, the real-capture front end: an 8-frame LiveScene-real capture at
# 640x480 with a Brown distortion (k4 = 0) and per-frame intrinsics, and an
# 8-frame CoNeRF capture at 1296x968 read at rgb/2x (648x484), both rendered
# from the bench scene; the train verbs start from CAPTURE_SEEDS seed points
# (every fourth bench mean)
CAPTURE_FRAMES = 8
CAPTURE_DISTORTION = {"k1": -0.12, "k2": 0.03, "k3": 0.0, "k4": 0.0, "p1": 0.001, "p2": -0.0015}
CAPTURE_SEED_STRIDE = 4
CAPTURE_STEPS = 24
CAPTURE_EVAL_AT = 16
CONERF_STEPS = 10
CONERF_KEY_FRAMES = [0, 3, 6]
CAPTURE_JPEG_QUALITY = 95
INTERFLOW_RTOL = 1e-4  # card against CPU, of the largest |flow|
# the bench scene moved into the real capture's frame, evaluated against its
# undistorted frames (JPEG q95, distorted and undistorted bilinearly):
# misplaced cameras or a wrong crop give ~10-15 dB
CAPTURE_MIN_PSNR = 25.0


def _capture_camera(c2w, fx, fy, cx, cy, t, width, height):
    import torch

    from freegaussian_tpu_torch.data.cameras import Camera

    f = lambda v: torch.tensor(np.asarray(v, np.float32), device=DEVICE)
    return Camera(c2w=f(c2w), fx=f(fx), fy=f(fy), cx=f(cx), cy=f(cy), time=f(t), width=width, height=height)


def write_real_capture(tmp: Path, model) -> dict:
    """A LiveScene real capture in nerfstudio's layout at SERVE_WH:
    transforms.json (per-frame fl_x / fl_y / cx / cy and Brown distortion,
    `mask_path`), JPEG frames, `masks/{fid}.npy` (M = 2, seeded boxes),
    foreground PNGs, `sparse_pc.ply` (every CAPTURE_SEED_STRIDE-th bench
    mean), `depth/{stem}.npy` and seeded `opticalflow/{stem}.npy` (frame 5
    has none: zero flow). The frames are the bench scene, moved into the
    dataset's frame as `parse_real` will place it (its orient, center and
    auto-scale of these poses), rendered through each frame's pinhole camera
    and then distorted by the frame's model: each distorted pixel samples
    the pinhole frame (bilinear) where the port's `undistort_points` puts
    it. The depth maps are the port's `render_depth_maps` of the same scene
    at the same pinhole cameras."""
    import copy

    import torch
    from PIL import Image

    from freegaussian_tpu_torch.data import undistort as ud
    from freegaussian_tpu_torch.data.dataparsers import auto_orient_and_center_poses, auto_scale_poses
    from freegaussian_tpu_torch.data.ply import write_ply_points
    from freegaussian_tpu_torch.ops.math import bilinear_interp
    from freegaussian_tpu_torch.preprocess.render_offline import render_depth_maps
    from freegaussian_tpu_torch.viewer.server import orbit_camera

    t0 = time.perf_counter()
    width, height = SERVE_WH
    root = tmp / "real_capture"
    for sub in ("images", "fg", "masks", "opticalflow"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(SEED + 81)
    n = CAPTURE_FRAMES
    frames = []
    px = width / 640.0  # intrinsics in 640-wide pixels
    for i in range(n):
        cam = orbit_camera(-0.6 + 1.2 * i / (n - 1), 0.15, 6.0, width=width, height=height, device=DEVICE)
        c2w = np.eye(4)
        c2w[:3] = cam.c2w.cpu().numpy()
        stem = f"frame_{i:04d}"
        frames.append({
            "file_path": f"images/{stem}.jpg", "mask_path": f"fg/{stem}.png", "transform_matrix": c2w.tolist(),
            "fl_x": px * (500.0 + 2.0 * i), "fl_y": px * (501.0 + 2.0 * i), "cx": width / 2 + px * 2.5 * (i - 3.5),
            "cy": height / 2 - px * 1.5 * (i - 3.5), **CAPTURE_DISTORTION,
        })
    meta = {"frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    # parse_real's own pose arithmetic on the same (float32) poses
    poses = np.stack([np.array(f["transform_matrix"], np.float32) for f in json.loads((root / "transforms.json").read_text())["frames"]])
    poses, transform = auto_orient_and_center_poses(poses)
    scale = auto_scale_poses(poses)
    poses[:, :3, 3] *= scale
    moved = copy.deepcopy(model)
    with torch.no_grad():
        T = torch.as_tensor(transform, device=DEVICE)
        moved.gauss_params["means"].copy_((moved.gauss_params["means"] @ T[:, :3].T + T[:, 3]) * scale)
        moved.gauss_params["scales"].add_(float(np.log(scale)))
    k = CAPTURE_DISTORTION
    dist = [k["k1"], k["k2"], k["p1"], k["p2"], k["k3"], k["k4"], 0.0, 0.0]
    ys, xs = torch.meshgrid(torch.arange(height, device=DEVICE), torch.arange(width, device=DEVICE), indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).reshape(-1, 2).double()
    pinholes = []
    for i, f in enumerate(frames):
        stem = Path(f["file_path"]).stem
        cam = _capture_camera(poses[i, :3], f["fl_x"], f["fl_y"], f["cx"], f["cy"], i / (n - 1), width, height)
        pinholes.append(cam)
        rgb = moved(cam)["rgb"]
        K_cv = np.array([[f["fl_x"], 0, f["cx"] - 0.5], [0, f["fl_y"], f["cy"] - 0.5], [0, 0, 1]], np.float64)
        src = ud.undistort_points(grid, K_cv, dist, K_cv).float()  # the pinhole pixel of each distorted pixel
        img = bilinear_interp(rgb[None], src[None, :, 0], src[None, :, 1])[0].reshape(height, width, 3)
        Image.fromarray((img.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()).save(
            root / f["file_path"], "JPEG", quality=CAPTURE_JPEG_QUALITY)
        fg = np.full((height, width), 255, np.uint8)
        fg[:, : 8 + i] = 0
        Image.fromarray(fg).save(root / f["mask_path"])
        mask = np.zeros((height, width, 3), bool)
        for c in (1, 2):
            y, x = rng.integers(0, height // 2), rng.integers(0, width // 2)
            mask[y : y + height // 3, x : x + width // 3, c] = True
        mask[..., 0] = ~mask[..., 1:].any(-1)
        np.save(root / "masks" / f"{i:04d}.npy", mask)
        if i != 5:
            np.save(root / "opticalflow" / f"{stem}.npy", rng.normal(size=(height, width, 2)).astype(np.float32))
    render_depth_maps(moved.cfg, moved.params, moved.alive, pinholes, root / "depth", dataparser_scale=scale,
                      deform=moved.deform, names=[Path(f["file_path"]).stem for f in frames])
    means = model.params["means"][model.alive][::CAPTURE_SEED_STRIDE].cpu().numpy()
    write_ply_points(root / "sparse_pc.ply", means, rng.integers(0, 256, size=(len(means), 3)).astype(np.uint8))
    mib = sum(f.stat().st_size for f in root.rglob("*") if f.is_file()) / 2**20
    print(f"captures real: {n} frames at {width}x{height}, JPEG q{CAPTURE_JPEG_QUALITY}, distortion {CAPTURE_DISTORTION}, "
          f"per-frame intrinsics, {len(means)} seed points, parse transform scale {scale:.4f}; {mib:.1f} MiB, written in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"root": root, "transform": transform, "scale": scale, "dist": dist, "frames": frames, "model": moved}


def check_undistortion(capture: dict, card: str) -> dict:
    """`undistort_frame` of frame 3 (image, foreground mask, M + 1 = 3
    articulation masks, depth, flow) on the card against the port's CPU run:
    the camera and the ROI equal, and every array bit-equal (the undistortion
    is float64 elementwise arithmetic in a fixed order on both devices, and
    the bilinear remap integer arithmetic); ms a frame on the card."""
    import torch

    from freegaussian_tpu_torch.data.datamanager import undistort_frame
    from freegaussian_tpu_torch.data.images import read_image

    root, f = capture["root"], capture["frames"][3]
    stem = Path(f["file_path"]).stem
    K = np.array([[f["fl_x"], 0, f["cx"]], [0, f["fl_y"], f["cy"]], [0, 0, 1]], np.float32)
    d = CAPTURE_DISTORTION
    dist = np.array([d["k1"], d["k2"], d["k3"], d["k4"], d["p1"], d["p2"]], np.float32)
    args = dict(mask=read_image(root / f["mask_path"]) > 127, depth=np.load(root / "depth" / f"{stem}.npy")[..., None],
                flow=np.load(root / "opticalflow" / f"{stem}.npy"), atrb_mask=np.load(root / "masks" / "0003.npy"))
    image = read_image(root / f["file_path"])
    t0 = time.perf_counter()
    cpu = undistort_frame(K, dist, image, device="cpu", **args)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_out = undistort_frame(K, dist, image, device=DEVICE, **args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    names = ("K", "image", "mask", "depth", "flow", "atrb_mask")
    differ = {n: int((a != b).sum()) if a.shape == b.shape else -1 for n, a, b in zip(names, card_out, cpu)}
    flow_max = float(np.abs(card_out[4] - cpu[4]).max()) if card_out[4].shape == cpu[4].shape else float("inf")
    ms = statistics.median(times)
    print(f"captures undistort: frame 3, {image.shape[1]}x{image.shape[0]} -> {card_out[1].shape[1]}x{card_out[1].shape[0]}, "
          f"K' {card_out[0].tolist()}; card vs CPU elements that differ {json.dumps(differ)} (budget 0 each), flow max "
          f"|diff| {flow_max:.3g} px; {ms:.2f} ms a frame on the card (median of 5, synced host clock, the host copies "
          f"in), {cpu_ms:.0f} ms on the CPU ({card})")
    if any(differ.values()):
        raise AssertionError(f"captures undistort: card and CPU differ: {differ}")
    return {"ms": ms, "cpu_ms": cpu_ms, "shape": card_out[1].shape[:2]}


def check_interflow(capture: dict, card: str) -> dict:
    """The `interflow` verb in process on the card, both forms, from the
    capture's depth renders and optical flow, against
    `generate_interflow_dataset` on the CPU over the same files: the
    largest difference in px and relative to the largest flow (budget
    INTERFLOW_RTOL). The velocity form's maps stay in flow_n2/ for the train
    verb."""
    import shutil

    import torch

    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.preprocess.epipolar_flow import generate_interflow_dataset

    root = capture["root"]
    result = {}
    for form in ("backproject", "velocity"):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        n = cli.main(["interflow", "--data", str(root), "--dataparser", "real", "--interval", "2", "--form", form,
                      "--device", DEVICE])
        wall = time.perf_counter() - t0
        if any(launches().values()):
            raise AssertionError(f"captures interflow launched kernels: {launches()}")
        generate_interflow_dataset(root, interval=2, form=form, dataparser="real", out_dir=f"flow_cpu_{form}",
                                   device="cpu")
        worst, largest = 0.0, 0.0
        for path in sorted((root / "flow_n2").glob("*.npy")):
            got, want = np.load(path), np.load(root / f"flow_cpu_{form}" / path.name)
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"captures interflow {form} {path.name}: {got.shape} vs {want.shape}")
            worst = max(worst, float(np.abs(got - want).max()))
            largest = max(largest, float(np.abs(want).max()))
        ms = wall / n * 1e3
        print(f"captures interflow {form}: {n} maps; card vs CPU max |diff| {worst:.3g} px, {worst / max(largest, 1e-30):.2e} of the "
              f"largest |flow| {largest:.1f} px (budget {INTERFLOW_RTOL:g}); {ms:.1f} ms a frame with the npy reads "
              f"and writes ({card})")
        if n != CAPTURE_FRAMES or worst > INTERFLOW_RTOL * largest or not largest > 0:
            raise AssertionError(f"captures interflow {form}: {n} maps, max |diff| {worst} of {largest}")
        result[form] = {"ms": ms, "max_diff": worst, "largest": largest}
        if form == "backproject":
            shutil.move(str(root / "flow_n2"), str(root / "flow_card_backproject"))
    return result


def _capture_overlay(path: Path, out: Path, steps: int, eval_at: int) -> Path:
    path.write_text(
        f"max_num_iterations: {steps}\nsteps_per_log: 1\nsteps_per_save: 0\nsteps_per_eval_image: 0\n"
        f"steps_per_eval_all_images: {eval_at}\noutput_dir: {out}\n"
        "pipeline:\n  model:\n    warm_up: 0\n    num_downscales: 0\n"
    )
    return path


def check_capture_kernels(label: str, model, camera, shapes) -> dict:
    """Rows 1, 2, 8 and 9 against their plain versions at a capture's own
    frame: `model` (the bench scene in the capture's frame) seen from
    `camera`, a frame the verbs ran on (its size not a multiple of the
    tile, its principal point off centre), at each (C, tile) that the
    verbs' compositor forwards and backwards took at that size (`shapes`,
    from `_run_verb`), with phase 4's budgets; then the deform field on that
    frame's means and time."""
    width, height = camera.width, camera.height
    inputs, field_args = pixel_stage_inputs(model, camera)
    seen = {(walk, C, tile) for walk, C, w, h, tile in shapes if (w, h) == (width, height)}
    fwd = sorted((tile, C) for walk, C, tile in seen if walk == "fwd")
    bwd = sorted((tile, C) for walk, C, tile in seen if walk == "bwd")
    if not (fwd and bwd):
        raise AssertionError(f"captures kernels {label}: no compositor forward and backward at {width}x{height}: {shapes}")
    rows, bwd_rows = [], []
    for tile in sorted({t for t, _ in fwd}):
        rows += _check_forward(inputs, width, height, (tile,), [C for t, C in fwd if t == tile], label, timed=False)[0]
    for tile in sorted({t for t, _ in bwd}):
        bwd_rows += _check_backward(*inputs, width, height, None, frame=label, tiles=(tile,),
                                    channels=[C for t, C in bwd if t == tile])
    deform = _check_deform(*field_args, timed=False)
    out = {
        "frame": f"{width}x{height}", "cx": float(camera.cx), "cy": float(camera.cy), "fwd": fwd, "bwd": bwd,
        "fwd_max_abs_err": max(r["max_abs_err"] for r in rows),
        "bwd_max_outside_share": max(r["outside_share"] for r in bwd_rows),
        "deform_fwd_max_abs_err": deform["fwd"]["max_abs_err"], "deform_bwd_max_abs_err": deform["bwd"]["max_abs_err"],
    }
    print(f"captures kernels {label}: " + json.dumps(out))
    return out


def train_real_capture(capture: dict, model, bare_step_ms: float, card: str) -> dict:
    """The `train` verb on the real capture (configs/real/base.yaml and an
    overlay: warm-up 0, CAPTURE_STEPS steps, one eval at CAPTURE_EVAL_AT),
    from its seed points: setup s and the undistortion's share of it, step
    ms after the first epoch against phase 7's bare step, eval PSNR, and
    rows 1, 2, 8 and 9 launched; then `eval` of the bench scene moved into
    the capture's frame, whose PSNR against the undistorted frames says
    whether parse, undistortion and cameras agree; then rows 1, 2, 8 and 9
    against their plain versions at the trained frame's shape
    (`check_capture_kernels`). The undistortion runs on the datamanager's
    two loader threads: each call's synced span, and their union."""
    import threading

    import torch

    from freegaussian_tpu_torch.data import datamanager

    root = capture["root"]
    out = root.parent / "real_out"
    over = _capture_overlay(root.parent / "real_over.yaml", out, CAPTURE_STEPS, CAPTURE_EVAL_AT)
    flags = ["--data", root, "--config", HERE / "configs/real/base.yaml", "--scene-config", over,
             "--capacity", VERB_CAPACITY, "--device", DEVICE]
    real_undistort, spans = datamanager.undistort_frame, []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real_undistort(*args, **kwargs)
        torch.cuda.synchronize()
        spans.append((t0, time.perf_counter(), threading.get_ident()))
        return result

    datamanager.undistort_frame = timed
    try:
        run = _run_verb(["train", *flags])
    finally:
        datamanager.undistort_frame = real_undistort
    trainer, counts = run["trainer"], run["launches"]
    camera, shapes = trainer.datamanager.frames[0].camera, set(run["shapes"])
    spent = [b - a for a, b, _ in spans]
    union, reach = 0.0, 0.0
    for a, b, _ in sorted(spans):
        union += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    train_rows, eval_rows = _verb_metrics(out)
    losses = [r["loss"] for r in train_rows]
    step_ms = [1e3 / r["steps_per_sec"] for r in train_rows]
    n_frames = len(trainer.datamanager)
    steady = statistics.median(step_ms[n_frames:])
    frame = trainer.datamanager.frames[0]
    psnr = [r["psnr"] for r in eval_rows]
    print(f"captures train: {CAPTURE_STEPS} steps on the real capture ({n_frames} frames undistorted to "
          f"{frame.camera.width}x{frame.camera.height}, cx {float(frame.camera.cx):.3f} cy {float(frame.camera.cy):.3f}), "
          f"{int(train_rows[0]['gaussian_count'])} Gaussians from its seed points; setup {run['setup_s']:.2f} s, of which "
          f"undistortion {union:.3f} s of wall time over {len(spent)} frames (both splits) on "
          f"{len({t for _, _, t in spans})} loader threads: per call {json.dumps([round(v * 1e3, 2) for v in spent])} ms, "
          f"their sum {sum(spent):.3f} s; step ms after the first epoch "
          f"{steady:.2f} against phase 7's bare step {bare_step_ms:.2f} ({steady / bare_step_ms:.2f}x); loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; eval psnr {psnr}; launches {json.dumps(counts)} ({card})")
    if len(losses) != CAPTURE_STEPS or not all(np.isfinite(v) for v in losses) or len(eval_rows) != 1:
        raise AssertionError(f"captures train: losses {losses}, eval rows {eval_rows}")
    for name in ("rasterize_fwd", "rasterize_bwd", "deform_fwd", "deform_bwd", "adam"):
        if not counts[name] > 0:
            raise AssertionError(f"captures train launched {name} {counts[name]} times")
    ckpt = bench_scene_checkpoint(trainer, model, root.parent / "real_bench_checkpoints", transform=capture["transform"],
                                  scale=capture["scale"])
    setup_s = run["setup_s"]
    del trainer, run
    report_path = root.parent / "real_eval.json"
    ev = _run_verb(["eval", *flags, "--load", ckpt, "--report", report_path])
    shapes |= ev["shapes"]
    report = json.loads(report_path.read_text())
    print(f"captures eval: the bench scene in the capture's frame against its {len(ev['trainer'].datamanager)} "
          f"undistorted frames: psnr {report['psnr']:.3f}, ssim {report['ssim']:.4f} (at least {CAPTURE_MIN_PSNR}); "
          f"setup {ev['setup_s']:.2f} s, launches {json.dumps(ev['launches'])} ({card})")
    if not report["psnr"] >= CAPTURE_MIN_PSNR:
        raise AssertionError(f"captures eval: psnr {report['psnr']}")
    total = {k: counts[k] + ev["launches"][k] for k in counts}
    del ev
    kernels = check_capture_kernels("real", capture["model"], camera, shapes)
    return {"launches": total, "setup_s": setup_s, "undistort_s": union, "undistort_call_ms": spent, "step_ms": steady,
            "eval_psnr": report["psnr"], "kernels": kernels}


def write_conerf_capture(tmp: Path, model) -> Path:
    """A CoNeRF capture at NATIVE_WH read at rgb/2x: dataset.json (7 train
    ids, 1 val), camera/{fid}.json (OpenCV orientation, position, focal and
    principal point at full size), scene.json (scale 1, centre 0, a bbox),
    points.ply (every CAPTURE_SEED_STRIDE-th bench mean), PNG frames of the
    bench scene at 648x484, polygon annotations for M = 2 on
    CONERF_KEY_FRAMES (seeded star polygons, full-size coordinates) and
    values.yaml."""
    import yaml

    from freegaussian_tpu_torch.data.ply import write_ply_points
    from freegaussian_tpu_torch.viewer.png import encode_png
    from freegaussian_tpu_torch.viewer.server import orbit_camera, to_rgb8

    t0 = time.perf_counter()
    root = tmp / "conerf_capture"
    width, height = NATIVE_WH[0] // 2, NATIVE_WH[1] // 2
    for sub in ("camera", "rgb/2x", "annotations"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(SEED + 91)
    n = CAPTURE_FRAMES
    ids = [f"{i:06d}" for i in range(n)]
    (root / "dataset.json").write_text(json.dumps({"ids": ids, "train_ids": ids[:-1], "val_ids": ids[-1:]}))
    (root / "scene.json").write_text(json.dumps({"scale": 1.0, "center": [0.0, 0.0, 0.0],
                                                 "bbox": [[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]]}))
    for i, fid in enumerate(ids):
        fx = 500.0 * width / 640.0
        cx, cy = width / 2 + 1.5, height / 2 - 1.0
        cam = orbit_camera(-0.6 + 1.2 * i / (n - 1), 0.15, 6.0, width=width, height=height, fx=fx, time=i / (n - 1),
                           device=DEVICE)
        cam = _capture_camera(cam.c2w.cpu().numpy(), fx, fx, cx, cy, i / (n - 1), width, height)
        (root / "rgb/2x" / f"{fid}.png").write_bytes(encode_png(to_rgb8(model(cam)["rgb"])))
        R = cam.c2w.cpu().numpy()[:, :3].copy()
        R[:, 1:3] *= -1  # OpenGL -> OpenCV axes
        (root / "camera" / f"{fid}.json").write_text(json.dumps({
            "orientation": R.T.tolist(), "position": cam.c2w.cpu().numpy()[:, 3].tolist(),
            "focal_length": 2 * fx, "principal_point": [2 * cx, 2 * cy],
        }))
    values = []
    for i in CONERF_KEY_FRAMES:
        polygons = []
        for a in range(2):
            c = rng.uniform([0.25 * NATIVE_WH[0], 0.25 * NATIVE_WH[1]], [0.75 * NATIVE_WH[0], 0.75 * NATIVE_WH[1]])
            ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
            r = rng.uniform(60, 260, 9) * NATIVE_WH[0] / 1296
            polygons.append({"attribute": a, "points": np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1).round(1).tolist()})
            values.append({"frame": i, "class": a, "value": float(rng.uniform(-1, 1))})
        (root / "annotations" / f"{ids[i]}.json").write_text(json.dumps({"polygons": polygons}))
    (root / "values.yaml").write_text(yaml.safe_dump(values))
    means = model.params["means"][model.alive][::CAPTURE_SEED_STRIDE].cpu().numpy()
    write_ply_points(root / "points.ply", means, rng.integers(0, 256, size=(len(means), 3)).astype(np.uint8))
    print(f"captures conerf: {n} frames at {NATIVE_WH[0]}x{NATIVE_WH[1]} read at rgb/2x ({width}x{height}), polygon "
          f"annotations for M = 2 on frames {CONERF_KEY_FRAMES}, written in {time.perf_counter() - t0:.1f} s")
    return root


def train_conerf_capture(root: Path, model, card: str) -> dict:
    """The `train` verb on the CoNeRF capture (configs/conerf/base.yaml,
    warm-up 0, CONERF_STEPS steps) from its points.ply, rows 1, 2, 8 and 9
    launched; then `cluster` over its polygon masks with the bench scene
    (already in the capture's frame: scale 1, centre 0) as the checkpoint,
    the vote held against the plain compositor's on the same inputs; then
    rows 1, 2, 8 and 9 against their plain versions at the 648x484 frame
    (`check_capture_kernels`)."""
    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.ops import rasterize_cuda
    from freegaussian_tpu_torch.preprocess.clustering import cluster_gaussians

    out = root.parent / "conerf_out"
    over = _capture_overlay(root.parent / "conerf_over.yaml", out, CONERF_STEPS, 0)
    flags = ["--data", root, "--config", HERE / "configs/conerf/base.yaml", "--scene-config", over,
             "--capacity", VERB_CAPACITY, "--device", DEVICE]
    run = _run_verb(["train", *flags])
    trainer, counts, shapes = run["trainer"], run["launches"], set(run["shapes"])
    rows, _ = _verb_metrics(out)
    losses = [r["loss"] for r in rows]
    step_ms = [1e3 / r["steps_per_sec"] for r in rows]
    cam = trainer.datamanager.frames[0].camera
    print(f"captures conerf train: {CONERF_STEPS} steps at {cam.width}x{cam.height} ({len(trainer.datamanager)} train "
          f"frames, {int(rows[0]['gaussian_count'])} Gaussians from points.ply); setup {run['setup_s']:.2f} s; step ms "
          f"median {statistics.median(step_ms[1:]):.2f}; loss {losses[0]:.5f} -> {losses[-1]:.5f}; launches "
          f"{json.dumps(counts)} ({card})")
    if (cam.width, cam.height) != (NATIVE_WH[0] // 2, NATIVE_WH[1] // 2) or len(losses) != CONERF_STEPS \
            or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"captures conerf train: {cam.width}x{cam.height}, losses {losses}")
    for name in ("rasterize_fwd", "rasterize_bwd", "deform_fwd", "deform_bwd", "adam"):
        if not counts[name] > 0:
            raise AssertionError(f"captures conerf train launched {name} {counts[name]} times")
    ckpt = bench_scene_checkpoint(trainer, model, root.parent / "conerf_bench_checkpoints", transform=np.eye(4, dtype=np.float32)[:3])
    del trainer, run
    cl = _run_verb(["cluster", *flags, "--load", ckpt])
    shapes |= cl["shapes"]
    ctrainer = cl["trainer"]
    st = ctrainer.state
    got = np.load(root / f"gaussian_mask_{int(st.alive.sum())}x2.npy")
    masks, cameras, valids = cli.cluster_inputs(ctrainer)
    real_tiles = rasterize_cuda.rasterize_tiles
    rasterize_cuda.rasterize_tiles = rasterize_cuda.rasterize_tiles_plain
    try:
        plain = cluster_gaussians(st.params, st.alive, masks, cameras, mask_valids=valids or None)[st.alive].cpu().numpy()
    finally:
        rasterize_cuda.rasterize_tiles = real_tiles
    differ = int((got != plain).any(-1).sum())
    channels = {c: cl["channels"].count(c) for c in sorted(set(cl["channels"]))}
    print(f"captures conerf cluster: over {len(masks)} frames' polygon masks, mask {got.shape}, rows voted "
          f"{int(got.any(-1).sum())} ({got.any(-1).mean():.2%}), votes per attribute {got.sum(0).tolist()}; against the "
          f"plain compositor's vote {differ} rows differ; setup {cl['setup_s']:.2f} s, work {cl['work_s']:.2f} s; "
          f"launches {json.dumps(cl['launches'])}, compositor channels {json.dumps(channels)} ({card})")
    if differ > CLUSTER_MAX_DIFF * got.shape[0] or not got.any() or channels != {1: len(masks)}:
        raise AssertionError(f"captures conerf cluster: {differ} rows differ, channels {channels}")
    total = {k: counts[k] + cl["launches"][k] for k in counts}
    del ctrainer, st, cl
    kernels = check_capture_kernels("conerf", model, cam, shapes)
    return {"launches": total, "differ": differ, "voted": int(got.any(-1).sum()), "step_ms": statistics.median(step_ms[1:]),
            "kernels": kernels}


def phase_captures(tmp: Path, model, bare_step_ms: float, card: str) -> dict:
    """Phase 20 (the module docstring): the real-capture front end on the card."""
    real = write_real_capture(tmp, model)
    undistort = check_undistortion(real, card)
    interflow = check_interflow(real, card)
    train = train_real_capture(real, model, bare_step_ms, card)
    conerf = train_conerf_capture(write_conerf_capture(tmp, model), model, card)
    total = {k: train["launches"][k] + conerf["launches"][k] for k in train["launches"]}
    print(f"captures launches: {json.dumps(total)}")
    return {"launches": total, "undistort": undistort, "interflow": interflow, "train": train, "conerf": conerf}


# ---------------------------------------------------------------------------
# the last training features: camera optimization and the bilateral grid;
# band frames; the multi-GPU step
# ---------------------------------------------------------------------------

EXTRAS_MODEL = dict(camera_optimizer_mode="SO3xR3", use_bilateral_grid=True)
# the step without the extras, with each alone, with both
EXTRAS_VARIANTS = {"none": None, "camera_opt": dict(camera_optimizer_mode="SO3xR3"),
                   "bilateral_grid": dict(use_bilateral_grid=True), "both": EXTRAS_MODEL}
EXTRAS_STEPS = 30  # rounds of EXTRAS_VARIANTS in turns; the first two are not timed
# camera_opt's and bilateral_grid's Adam first moments between two extras
# steps that should agree (card and CPU; kernels and the plain compositor),
# relative L2: 70x the larger of the card-vs-CPU readings (1.4e-6, 7.1e-7;
# PERF.md), well below an error the size of bf16's rounding
EXTRAS_CHECK_RTOL = 1e-4
EXTRAS_VERB_STEPS = 10
EXTRAS_VERB_RANDOM = 20_000
EXTRAS_VERB_CAPACITY = 1 << 16
# (bands, tile) of the 480-row bench frame; (2, 32) is phase 23's (1, 2) mesh
BAND_CASES = ((2, 16), (2, 32), (3, 32))
PARALLEL_STEPS = 60
PARALLEL_GLOO_MESHES = ((1, 2), (2, 1))  # (data, tile) of the two ranks on one card


def _rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


@contextlib.contextmanager
def plain_compositor():
    """Within it, the pixel stage runs the tile compositor's plain versions,
    forward and backward, in place of rows 1 and 2 (phase 19's swap of the
    forward, with the backward's too)."""
    from freegaussian_tpu_torch.ops import rasterize_cuda

    real = rasterize_cuda.rasterize_tiles, rasterize_cuda.rasterize_tiles_bwd

    def bwd(m2d, con, colors, opac, radii, gauss_ids, tile_offsets, livecnt, t_final, g_color, g_alpha, width, height, tile):
        return rasterize_cuda.rasterize_tiles_bwd_plain(m2d, con, colors, opac, radii, gauss_ids, tile_offsets, g_color,
                                                        g_alpha, width, height, tile)

    rasterize_cuda.rasterize_tiles, rasterize_cuda.rasterize_tiles_bwd = rasterize_cuda.rasterize_tiles_plain, bwd
    try:
        yield
    finally:
        rasterize_cuda.rasterize_tiles, rasterize_cuda.rasterize_tiles_bwd = real


def _first_moments(state) -> dict:
    return {g: {k: v.detach().clone() for k, v in st.mu.items()} for g, st in state.opt_states.items()}


def _hold_extras_step(label: str, got, want, card: str) -> dict:
    """One extras step's (loss, first moments) against another's: the loss
    within rtol 1e-4, camera_opt's and bilateral_grid's moments within
    EXTRAS_CHECK_RTOL relative L2, every other tensor's within
    TRAIN_CHECK_RTOL. Returns each group's worst tensor."""
    (lg, mug), (lw, muw) = got, want
    errs = {f"{g}.{k}": _rel_l2(mug[g][k].cpu(), w.cpu()) for g, moments in muw.items() for k, w in moments.items()}
    worst = {g: max(v for k, v in errs.items() if k.startswith(g + ".")) for g in muw}
    print(f"extras check {label}: loss {lg:.7f} vs {lw:.7f}; Adam first moment, relative L2 difference, worst tensor "
          f"of each group: {json.dumps({g: float(f'{v:.3g}') for g, v in worst.items()})} ({card})")
    if not {"camera_opt", "bilateral_grid"} <= set(worst):
        raise AssertionError(f"extras check {label}: groups {sorted(worst)}")
    if not abs(lg - lw) <= 1e-4 * abs(lw):
        raise AssertionError(f"extras check {label}: loss {lg} vs {lw}")
    for g, v in worst.items():
        if v > (EXTRAS_CHECK_RTOL if g in ("camera_opt", "bilateral_grid") else TRAIN_CHECK_RTOL):
            raise AssertionError(f"extras check {label}: the steps differ in group {g}: {v}")
    return worst


def phase_extras(tmp: Path, data: Path, model, card: str) -> dict:
    """Camera optimization (SO3xR3) and the bilateral grid in the stage-1
    step (`_hold_extras_step`'s budgets: loss rtol 1e-4, camera_opt's and
    bilateral_grid's first moments within EXTRAS_CHECK_RTOL, every other
    within TRAIN_CHECK_RTOL): one step on the card against the CPU (phase
    7's check size, 4000 Gaussians at 160x120, the deform field in f32,
    the same draws), and one step at the bench point with the kernels
    against the same step with the plain compositor on the card
    (`plain_compositor`; the CPU's would take minutes there). At the bench
    point, EXTRAS_VARIANTS' steps in turns, EXTRAS_STEPS rounds (median ms
    after two; launches of the steps with both, zeroed before each and
    read after; each variant's cost over the step without the extras, the
    median of the rounds' differences), which splits the extras' cost
    between the camera and the grid; the grid's slice at 640x480 (forward, and forward + backward),
    its total-variation loss and the camera adjustment with their
    backwards (CUDA events). The `train` verb with both enabled by the
    YAML overlay over phase 13's dataset (EXTRAS_VERB_STEPS steps from
    EXTRAS_VERB_RANDOM random Gaussians), its checkpoint reloaded equal,
    and `eval` over it. Launches are zeroed before each path and read
    after."""
    import dataclasses

    import torch

    from freegaussian_tpu_torch.engine import checkpoints
    from freegaussian_tpu_torch.models.bilagrid import init_bilateral_grids, slice_bilateral_grid, total_variation_loss
    from freegaussian_tpu_torch.models.camera_opt import apply_camera_opt, camera_opt_reg_loss
    from freegaussian_tpu_torch.models.splat_model import SplatModel

    n = min(4000, N_GAUSS)
    small = SplatModel(dataclasses.replace(model.cfg, deform_bf16=False), n, device="cpu")
    with torch.no_grad():
        for k, v in model.params.items():
            small.gauss_params[k].copy_(v[:n].cpu())
        small.alive.copy_(model.alive[:n].cpu())
        small.deform.load_state_dict({k: v.float().cpu() for k, v in model.deform.state_dict().items()})
    g = torch.Generator().manual_seed(SEED + 72)
    draws = {"background": torch.rand(3, generator=g), "split_eps": (torch.randn(n, 3, generator=g), torch.randn(n, 3, generator=g))}
    out = {}
    for dev in (DEVICE, "cpu"):
        state, step_fn, camera, camera0, batch = build_train_case(small, 160, 120, device=dev, flow_3d=False, extras=True)
        state, m = step_fn(state, camera, batch, 3, camera0=camera0, draws=draws)
        out[dev] = (float(m["loss"]), _first_moments(state))
    check_cpu = _hold_extras_step("160x120 GPU vs CPU", out[DEVICE], out["cpu"], card)

    width, height = SERVE_WH
    draws = {"background": torch.rand(3, generator=torch.Generator().manual_seed(SEED + 78))}
    out = {}
    for label in ("kernels", "plain"):
        state, step_fn, camera, camera0, batch = build_train_case(model, width, height, extras=True)
        t0 = time.perf_counter()
        with plain_compositor() if label == "plain" else contextlib.nullcontext():
            state, m = step_fn(state, camera, batch, 3, camera0=camera0, draws=draws)
            torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        out[label] = (float(m["loss"]), _first_moments(state))
        del state
    check_plain = _hold_extras_step(f"{width}x{height} tile 32, kernels vs the plain compositor on the card "
                                    f"(the plain step {plain_s:.1f} s)", out["kernels"], out["plain"], card)
    del out

    cases = {name: build_train_case(model, width, height, extras=over or False) for name, over in EXTRAS_VARIANTS.items()}
    states = {name: case[0] for name, case in cases.items()}
    ms = {name: [] for name in cases}
    step_launches = {k: 0 for k in launches()}
    for _ in range(EXTRAS_STEPS):
        for name, (_, step_fn, camera, camera0, batch) in cases.items():
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            states[name], m = step_fn(states[name], camera, batch, 3, camera0=camera0)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == "both":
                for k, v in launches().items():
                    step_launches[k] += v
            if not np.isfinite(float(m["loss"])) or not bool(m["params_finite"]):
                raise AssertionError(f"extras {name}: non-finite step, loss {float(m['loss'])}")
    if step_launches != step_launch_counts(EXTRAS_STEPS):
        raise AssertionError(f"extras steps: launches {step_launches}")
    step_ms = {name: statistics.median(v[2:]) for name, v in ms.items()}
    # each variant's cost: the median over rounds of its step minus that round's step without the extras
    over = {name: statistics.median(a - b for a, b in zip(ms[name][2:], ms["none"][2:])) for name in ms if name != "none"}
    state = states["both"]
    grid = state.bilagrid.detach()
    rgb = torch.rand(height, width, 3, generator=torch.Generator().manual_seed(SEED + 73)).to(DEVICE)
    grid_g = grid.clone().requires_grad_(True)
    cot = torch.randn(height, width, 3, generator=torch.Generator().manual_seed(SEED + 74)).to(DEVICE)
    adjust = state.camera_opt.detach().clone().requires_grad_(True)
    camera = cases["both"][2]
    parts = {
        "slice": cuda_ms(lambda: slice_bilateral_grid(grid, 0, rgb), reps=25),
        "slice_fwd_bwd": cuda_ms(lambda: torch.autograd.grad((slice_bilateral_grid(grid_g, 0, rgb) * cot).sum(), grid_g), reps=25),
        "tv_fwd_bwd": cuda_ms(lambda: torch.autograd.grad(total_variation_loss(grid_g), grid_g), reps=25),
        "camera_fwd_bwd": cuda_ms(lambda: torch.autograd.grad(
            apply_camera_opt(adjust, camera, 0).c2w.sum() + camera_opt_reg_loss(adjust), adjust), reps=25),
    }
    print(f"extras {width}x{height} tile 32: step ms (median of the last {EXTRAS_STEPS - 2} of {EXTRAS_STEPS}, variants in "
          f"turns, synced host clock) {json.dumps({k: round(v, 3) for k, v in step_ms.items()})}; over none (median of the rounds' "
          f"differences): camera_opt {over['camera_opt']:+.2f}, bilateral_grid {over['bilateral_grid']:+.2f}, "
          f"both {over['both']:+.2f}; launches of the steps with both {json.dumps(step_launches)}; "
          f"parts ms (CUDA events, median of 25) {json.dumps({k: round(v, 4) for k, v in parts.items()})} ({card})")
    del cases, states, state

    out_dir = tmp / "extras_out"
    over = tmp / "extras_over.yaml"
    over.write_text(
        f"max_num_iterations: {EXTRAS_VERB_STEPS}\nnum_random: {EXTRAS_VERB_RANDOM}\nsteps_per_log: 1\n"
        f"steps_per_save: 0\nsteps_per_eval_image: 0\nsteps_per_eval_all_images: 0\noutput_dir: {out_dir}\n"
        "pipeline:\n  model:\n    warm_up: 0\n    num_downscales: 0\n    camera_optimizer_mode: SO3xR3\n"
        "    use_bilateral_grid: true\n"
    )
    flags = ["--data", data, "--config", HERE / "configs/sim/base.yaml", "--scene-config", over,
             "--capacity", EXTRAS_VERB_CAPACITY, "--device", DEVICE]
    verb = _run_verb(["train", *flags])
    trainer = verb["trainer"]
    rows, _ = _verb_metrics(out_dir)
    if len(rows) != EXTRAS_VERB_STEPS or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"extras train verb: {len(rows)} logged steps")
    st = trainer.state
    if st.camera_opt is None or st.bilagrid is None or not float(st.camera_opt.detach().abs().max()) > 0:
        raise AssertionError("extras train verb: the adjustments did not train")
    ckpt = out_dir / "freegaussian" / "checkpoints"
    saved = checkpoints.state_dict(st)
    with torch.no_grad():
        st.camera_opt.add_(1.0)
        st.bilagrid.add_(1.0)
    trainer.load(ckpt)
    _assert_nested_equal(saved, checkpoints.state_dict(trainer.state), "extras checkpoint")
    ev = _run_verb(["eval", *flags, "--load", ckpt])
    if not torch.equal(ev["trainer"].state.camera_opt.cpu(), saved["camera_opt"]):
        raise AssertionError("extras eval: the served adjustments are not the checkpoint's")
    for label, run in (("train", verb), ("eval", ev)):
        need = ("rasterize_fwd", "rasterize_bwd", "deform_fwd", "deform_bwd", "adam") if label == "train" else ("rasterize_fwd", "deform_fwd")
        if not all(run["launches"][k] > 0 for k in need):
            raise AssertionError(f"extras {label} verb: launches {run['launches']}")
    print(f"extras train verb: {EXTRAS_VERB_STEPS} steps, loss {rows[0]['loss']:.6f} -> {rows[-1]['loss']:.6f}, setup "
          f"{verb['setup_s']:.1f} s, work {verb['work_s']:.2f} s; |camera_opt| max {float(saved['camera_opt'].abs().max()):.3g}, "
          f"grid moved {float((saved['bilagrid'] - init_bilateral_grids(len(saved['bilagrid']), device='cpu')).abs().max()):.3g}; "
          "checkpoint reloads equal; "
          f"eval setup {ev['setup_s']:.1f} s, work {ev['work_s']:.2f} s; launches train {json.dumps(verb['launches'])}, "
          f"eval {json.dumps(ev['launches'])}")
    total = {k: step_launches[k] + verb["launches"][k] + ev["launches"][k] for k in step_launches}
    return {"launches": total, "step_ms": step_ms, "over": over, "parts": parts, "check_cpu": check_cpu,
            "check_plain": check_plain}


def phase_bands(model, card: str) -> dict:
    """The bench frame (640x480) rendered in horizontal bands (rows 1 and 2
    on band frames: the pixel stage of `rasterization` with
    `tile_origin_y`), at each of BAND_CASES: band heights that are
    multiples of the tile size, and 2 bands of 240 rows at tile 32, which
    `make_parallel_train_step` renders at (data 1, tile 2) (phase 23): its
    last tile row is partial, and its tile grid is not the frame's. Each
    band's kernels against their plain versions on the band's own inputs
    (the bench scene shifted by the band's origin) with phase 4's budgets:
    the forward at C = 3 and 5 (`_check_forward`), the reverse-walk
    backward at C = 5, the training layout (`_check_backward`). Through
    `rasterize_pixels` (C = 3, seeded cotangents), stitched, against the
    full frame: the forward within KERNEL_ATOL; the per-Gaussian gradients
    (means2d, conics, colors, opacities, absgrad) summed over the bands, at
    most BWD_MAX_OUTSIDE of their elements outside rtol BWD_RTOL / atol
    BWD_ATOL. Where a band's tile grid is the frame's, also the backward
    kernel's rows of each band, absgrad included, against the frame's rows
    of the same (tile, Gaussian) pairs (the same ids in the same order) at
    the same budget, and the bands' intersections summing to the frame's.
    Where it is not, the absgrad (a sum over each kernel tile of |the
    tile's d means2d|) differs from the frame's by definition and is only
    reported. Each band's launches (zeroed before its forward and backward,
    read after) and its kernels' ms."""
    import torch

    from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_pixels, rasterize_tiles, rasterize_tiles_bwd
    from freegaussian_tpu_torch.ops.tiles import build_intersections

    width, height = SERVE_WH
    inputs, _ = pixel_stage_inputs(model, bench_camera(width, height, DEVICE))
    m2d, con, chans, opac, depths, radii = inputs
    colors = chans[:, :3].contiguous()
    g = torch.Generator(device="cpu").manual_seed(SEED + 75)
    g_color = torch.randn(height, width, 3, generator=g).to(DEVICE)
    g_alpha = torch.randn(height, width, 1, generator=g).to(DEVICE)
    names = ("means2d", "conics", "colors", "opacities", "absgrad")

    def shift(origin):
        return m2d - m2d.new_tensor([0.0, float(origin)])

    def render(origin, rows, tile):
        leaves = [t.clone().requires_grad_(True) for t in (m2d, con, colors, opac)]
        sink = torch.zeros_like(m2d, requires_grad=True)
        shifted = leaves[0] - leaves[0].new_tensor([0.0, float(origin)]) if origin else leaves[0]
        color, alpha, n_isects = rasterize_pixels(shifted, leaves[1], leaves[2], leaves[3], depths, radii, width, rows,
                                                  tile_size=tile, means2d_sink=sink)
        ((color * g_color[origin:origin + rows]).sum() + (alpha * g_alpha[origin:origin + rows]).sum()).backward()
        return torch.cat([color, alpha], -1).detach(), [t.grad for t in leaves] + [sink.grad], n_isects

    def kernel_rows(origin, rows, tile):
        """The band's binning, the kernels' forward and backward arguments, its backward rows."""
        shifted = shift(origin)
        isect = build_intersections(shifted, radii, depths, width, rows, tile)
        fwd_args = (shifted, con, colors, opac, radii, isect.gauss_ids, isect.tile_offsets)
        _, _, livecnt, t_final = rasterize_tiles(*fwd_args, width, rows, tile)
        gc, ga = g_color[origin:origin + rows].contiguous(), g_alpha[origin:origin + rows, :, 0].contiguous()
        bwd_args = (*fwd_args, livecnt, t_final, gc, ga, width, rows, tile)
        return isect, fwd_args, bwd_args, rasterize_tiles_bwd(*bwd_args)

    def outside(got, want):
        return int(((got - want).abs() > BWD_ATOL + BWD_RTOL * want.abs()).sum())

    out = {"rows": [], "plain": []}
    for n_bands, tile in BAND_CASES:
        rows = height // n_bands
        aligned = rows % tile == 0
        full, full_grads, full_isects = render(0, height, tile)
        f_isect, _, _, f_rows = kernel_rows(0, height, tile)
        band_tiles = (rows // tile) * f_isect.tiles_w
        parts, rows_outside, rows_elements = [], 0, 0
        for b in range(n_bands):
            origin = b * rows
            band_inputs = (shift(origin), con, chans, opac, depths, radii)
            label = f"band {b} of {n_bands} at tile {tile}"
            fwd_rows, _ = _check_forward(band_inputs, width, rows, (tile,), (3, 5), frame=label, timed=False)
            bwd_rows = _check_backward(*band_inputs, width, rows, None, frame=label, tiles=(tile,), channels=(5,))
            out["plain"] += fwd_rows + bwd_rows
            torch.cuda.synchronize()
            zero_launches()
            img, grads, n_isects = render(origin, rows, tile)
            torch.cuda.synchronize()
            counts = launches()
            if counts["rasterize_fwd"] != 1 or counts["rasterize_bwd"] != 1:
                raise AssertionError(f"{label}: launches {counts}")
            isect, fwd_args, bwd_args, b_rows = kernel_rows(origin, rows, tile)
            band = dict(bands=n_bands, band=b, tile=tile, rows=rows, aligned=aligned, num_isects=n_isects, launches=counts,
                        fwd_ms=cuda_ms(lambda: rasterize_tiles(*fwd_args, width, rows, tile), reps=25),
                        bwd_ms=cuda_ms(lambda: rasterize_tiles_bwd(*bwd_args), reps=25))
            if aligned:
                lo, hi = int(f_isect.tile_offsets[b * band_tiles]), int(f_isect.tile_offsets[(b + 1) * band_tiles])
                if not (torch.equal(isect.gauss_ids, f_isect.gauss_ids[lo:hi])
                        and torch.equal(isect.tile_ids + b * band_tiles, f_isect.tile_ids[lo:hi])):
                    raise AssertionError(f"{label}: its (tile, Gaussian) pairs are not the frame's")
                band_out = outside(b_rows, f_rows[lo:hi])
                rows_outside += band_out
                rows_elements += b_rows.numel()
                band.update(kernel_rows_outside_budget=band_out,
                            kernel_rows_max_abs_err=float((b_rows - f_rows[lo:hi]).abs().max()))
            print("bands " + json.dumps(band))
            parts.append((img, grads, n_isects))
        stitched = torch.cat([p[0] for p in parts])
        fwd_err = float((stitched - full).abs().max())
        summed = [sum(p[1][i] for p in parts) for i in range(len(names))]
        held = names if aligned else names[:4]
        grads_out = {k: outside(s_, w) for k, s_, w in zip(names, summed, full_grads)}
        elements = sum(w.numel() for k, w in zip(names, full_grads) if k in held)
        band_isects = sum(p[2] for p in parts)
        row = dict(bands=n_bands, tile=tile, aligned=aligned, fwd_max_abs_err=fwd_err, grads_outside_budget=grads_out,
                   grad_elements_held=elements, held=list(held),
                   max_abs_grad_err={k: float((s_ - w).abs().max()) for k, s_, w in zip(names, summed, full_grads)},
                   absgrad_per_gaussian_rel_l2=_rel_l2(summed[4], full_grads[4]), kernel_rows_outside_budget=rows_outside,
                   kernel_row_elements=rows_elements, num_isects_bands=band_isects, num_isects_frame=full_isects)
        print(f"bands stitched ({card}) " + json.dumps(row))
        if fwd_err > KERNEL_ATOL:
            raise AssertionError(f"{n_bands} bands at tile {tile}: stitched frame off the full frame by {fwd_err}")
        if sum(grads_out[k] for k in held) > BWD_MAX_OUTSIDE * elements or rows_outside > BWD_MAX_OUTSIDE * rows_elements:
            raise AssertionError(f"{n_bands} bands at tile {tile}: gradients outside the budget {grads_out} of {elements}, "
                                 f"kernel rows {rows_outside} of {rows_elements}")
        if aligned and band_isects != full_isects:
            raise AssertionError(f"{n_bands} bands at tile {tile}: {band_isects} intersections, the frame {full_isects}")
        out["rows"].append(row)
    return out


def _same_on_ranks(t) -> bool:
    """Whether `t` is bit-equal on every rank (its elementwise max and min agree)."""
    import torch
    import torch.distributed as dist

    hi, lo = (t.detach().clone(memory_format=torch.contiguous_format) for _ in range(2))
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool((hi == lo).all())


def _gloo_rank(rank: int, port: int, mesh_shape, ckpt: str, queue):
    """One of two ranks of a (data, tile) mesh on this one card, over gloo
    with CUDA tensors (spawned by phase_parallel): the bench scene from the
    phase 3 checkpoint, phase 7's case, one parallel step (data 2: the
    second rank's camera at t = 0.45), its launches, the ranks' parameters
    compared; rank 0 also takes the single step of each camera from the
    same state and draws."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint
    from freegaussian_tpu_torch.parallel.sharding import make_mesh, make_parallel_train_step, replicate_state, stack_cameras

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    try:
        data, tile = mesh_shape
        mesh = make_mesh(data, tile)
        model = load_reference_checkpoint(Path(ckpt), device=DEVICE)
        width, height = SERVE_WH
        cfg, optimizers, densify_cfg = train_case_config(model)
        state, _, camera, camera0, batch = build_train_case(model, width, height)
        state = replicate_state(state, mesh)
        cams = [camera, dataclasses.replace(camera, time=torch.full_like(camera.time, 0.45))][:data]
        rep = lambda t: t[None].expand(data, *t.shape).contiguous()
        step = make_parallel_train_step(cfg, densify_cfg, optimizers, 0, mesh, (height, width), with_flow=True)
        draws = {"background": torch.rand(3, generator=torch.Generator().manual_seed(SEED + 77))}
        start = {k: v.detach().clone() for k, v in state.params.items()}
        torch.cuda.synchronize()
        zero_launches()
        state, m = step(state, stack_cameras(cams), rep(batch["image"]), stack_cameras([camera0] * data), rep(batch["flow"]),
                        rep(batch["depth0"]), sh_degree_now=3, draws=draws)
        torch.cuda.synchronize()
        result = {"rank": rank, "loss": float(m["loss"]), "launches": launches(),
                  "equal": all(_same_on_ranks(v) for v in state.params.values())}
        if rank == 0:
            singles = []
            for cam in cams:
                st, step_s, _, _, b = build_train_case(model, width, height)
                st, ms = step_s(st, cam, b, 3, camera0=camera0, draws=draws)
                singles.append((float(ms["loss"]), st))
            # a group's first moment (its gradient) as one vector: the deform
            # field's small timenet gradients are sums over every Gaussian
            # with heavy cancellation, which shards and bands reorder
            flat = lambda st_: torch.cat([v.reshape(-1) for _, v in sorted(st_.mu.items())])
            mu = {g: _rel_l2(flat(st_), sum(flat(s_.opt_states[g]) for _, s_ in singles) / data)
                  for g, st_ in state.opt_states.items()}
            per_tensor = {f"{g}.{k}": _rel_l2(st_.mu[k], sum(s_.opt_states[g].mu[k] for _, s_ in singles) / data)
                          for g, st_ in state.opt_states.items() for k in st_.mu}
            result.update(single_loss=sum(l for l, _ in singles) / data, mu_worst=max(mu.values()),
                          mu_worst_at=max(mu, key=mu.get), mu_worst_tensor=max(per_tensor.values()),
                          mu_worst_tensor_at=max(per_tensor, key=per_tensor.get))
            if data == 1:
                single = singles[0][1]
                result["updates"] = {k: _rel_l2(state.params[k].detach() - start[k], single.params[k].detach() - start[k])
                                     for k in start}
        queue.put(result)
    finally:
        dist.destroy_process_group()


def phase_parallel(model, ckpt: Path) -> dict:
    """`make_parallel_train_step` at (data 1, tile 1) over NCCL, world size 1
    on this card (the process group set up here on a free localhost port),
    against the single-GPU step from the same state with the same draws, at
    the bench point (phase 7's case, flow losses on): after one step the
    loss within rtol 1e-4, every Adam first moment and every group's update
    (new parameters minus old) within TRAIN_CHECK_RTOL relative L2. Then
    PARALLEL_STEPS more steps of each, in turns (each first in every other
    round): median ms after two, the median of the paired differences, and
    the parallel steps' launches (zeroed just before them, read just after). Then two
    ranks on this card over gloo (`_gloo_rank`), at each of
    PARALLEL_GLOO_MESHES: one step's loss within rtol 1e-4 of the single
    steps' mean (data 2: one camera each), each group's Adam first moment
    (all its tensors as one vector) within TRAIN_CHECK_RTOL relative L2 of
    the mean of theirs, the ranks' parameters bit-equal, one step's launches
    on each rank; the worst single tensor and the updates are reported."""
    import socket

    import torch
    import torch.distributed as dist

    from freegaussian_tpu_torch.parallel.distributed import ensure_distributed
    from freegaussian_tpu_torch.parallel.sharding import make_mesh, make_parallel_train_step, replicate_state, stack_cameras

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if ensure_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device=DEVICE) != (0, 1):
        raise AssertionError("parallel: the process group is not rank 0 of 1")
    try:
        mesh = make_mesh(1, 1)
        width, height = SERVE_WH
        cfg, optimizers, densify_cfg = train_case_config(model)
        single = build_train_case(model, width, height)
        par = build_train_case(model, width, height)
        par_step = make_parallel_train_step(cfg, densify_cfg, optimizers, 0, mesh, (height, width), with_flow=True)
        state_s, step_s, camera, camera0, batch = single
        state_p = replicate_state(par[0], mesh)
        cams, cams0 = stack_cameras([camera]), stack_cameras([camera0])
        imgs, flows, depth0s = batch["image"][None], batch["flow"][None], batch["depth0"][None]
        g = torch.Generator().manual_seed(SEED + 76)
        draws = {"background": torch.rand(3, generator=g)}
        start = {k: v.detach().clone() for k, v in state_s.params.items()}
        state_s, ms_ = step_s(state_s, camera, batch, 3, camera0=camera0, draws=draws)
        state_p, mp_ = par_step(state_p, cams, imgs, cams0, flows, depth0s, sh_degree_now=3, draws=draws)
        ls, lp = float(ms_["loss"]), float(mp_["loss"])
        mu = {f"{gname}.{k}": _rel_l2(state_p.opt_states[gname].mu[k], v)
              for gname, st in state_s.opt_states.items() for k, v in st.mu.items()}
        upd = {k: _rel_l2(state_p.params[k].detach() - start[k], state_s.params[k].detach() - start[k]) for k in start}
        print(f"parallel (1, 1) NCCL vs the single step, one step at {width}x{height}: loss {lp:.7f} vs {ls:.7f}; "
              f"worst Adam first moment relative L2 {max(mu.values()):.3g} ({max(mu, key=mu.get)}); updates "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in upd.items()})}")
        if not abs(lp - ls) <= 1e-4 * abs(ls):
            raise AssertionError(f"parallel step loss {lp} vs single {ls}")
        for k, v in list(mu.items()) + list(upd.items()):
            if v > TRAIN_CHECK_RTOL:
                raise AssertionError(f"parallel step differs from the single step in {k}: {v}")
        ms = {"single": [], "parallel": []}
        counts = {k: 0 for k in launches()}
        for i in range(PARALLEL_STEPS):
            # the two in turns, each first in every other round
            for which in ("single", "parallel")[:: 1 if i % 2 == 0 else -1]:
                torch.cuda.synchronize()
                zero_launches()
                t0 = time.perf_counter()
                if which == "single":
                    state_s, m = step_s(state_s, camera, batch, 3, camera0=camera0)
                else:
                    state_p, m = par_step(state_p, cams, imgs, cams0, flows, depth0s, sh_degree_now=3)
                torch.cuda.synchronize()
                ms[which].append((time.perf_counter() - t0) * 1e3)
                if which == "parallel":
                    for k, v in launches().items():
                        counts[k] += v
                if not np.isfinite(float(m["loss"])):
                    raise AssertionError(f"{which} step: non-finite loss")
        if counts != step_launch_counts(PARALLEL_STEPS):
            raise AssertionError(f"parallel steps: launches {counts}")
        med = {k: statistics.median(v[2:]) for k, v in ms.items()}
        paired = statistics.median(p - s_ for p, s_ in zip(ms["parallel"][2:], ms["single"][2:]))
        print(f"parallel (1, 1) step {med['parallel']:.2f} ms against the single step's {med['single']:.2f} ms "
              f"(medians of the last {PARALLEL_STEPS - 2} of {PARALLEL_STEPS}, in turns, synced host clock; median of "
              f"the paired differences {paired:+.2f} ms; quartiles parallel "
              f"{[round(q, 2) for q in statistics.quantiles(ms['parallel'][2:], n=4)]}, single "
              f"{[round(q, 2) for q in statistics.quantiles(ms['single'][2:], n=4)]}); launches {json.dumps(counts)}")
        med["paired_diff"] = paired
    finally:
        dist.destroy_process_group()

    # two ranks on this card over gloo, which takes CUDA tensors for every
    # collective the step uses (PERF.md §7)
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    for mesh_shape in PARALLEL_GLOO_MESHES:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        queue = ctx.Queue()
        procs = [ctx.Process(target=_gloo_rank, args=(r, port, mesh_shape, str(ckpt), queue)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            results = sorted((queue.get(timeout=300) for _ in procs), key=lambda r: r["rank"])
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"parallel {mesh_shape} over gloo: exit codes {[p.exitcode for p in procs]}")
        r0 = results[0]
        print(f"parallel {mesh_shape} gloo, 2 ranks on this card: loss {r0['loss']:.7f} vs the single steps' "
              f"{r0['single_loss']:.7f}; worst group's Adam first moment relative L2 {r0['mu_worst']:.3g} ({r0['mu_worst_at']}; "
              f"worst tensor {r0['mu_worst_tensor']:.3g}, {r0['mu_worst_tensor_at']}); "
              f"updates {json.dumps({k: float(f'{v:.3g}') for k, v in r0.get('updates', {}).items()})}; ranks' "
              f"parameters bit-equal {all(r['equal'] for r in results)}; launches {json.dumps([r['launches'] for r in results])}")
        if not abs(r0["loss"] - r0["single_loss"]) <= 1e-4 * abs(r0["single_loss"]) or r0["mu_worst"] > TRAIN_CHECK_RTOL:
            raise AssertionError(f"parallel {mesh_shape} over gloo differs from the single steps: {r0}")
        if not all(r["equal"] for r in results) or results[1]["loss"] != r0["loss"]:
            raise AssertionError(f"parallel {mesh_shape} over gloo: the ranks disagree")
        for r in results:
            if r["launches"] != step_launch_counts(1):
                raise AssertionError(f"parallel {mesh_shape} rank {r['rank']}: launches {r['launches']}")
            for k, v in r["launches"].items():
                counts[k] += v
    return {"launches": counts, "ms": med}


# Phase 24: capacity-bounded binning, the ellipse cull, and scan_chunk as CUDA-graph replays
GRAPH_CHUNK = 10
GRAPH_STEPS = 2 * GRAPH_CHUNK  # two chunks
GRAPH_REFINE_AT = 15  # one refinement inside the second chunk, eagerly between replays
GRAPH_LOSS_RTOL = 1e-4  # the step's budget (TRAIN_CHECK_RTOL for the first moments)
CULL_ATOL = 2e-5


# the port's kernels by the names the profiler gives them
PORT_KERNEL_NAMES = ("rasterize_fwd", "rasterize_bwd_walk", "rasterize_bwd_combine", "field_fwd", "field_dgrad",
                     "field_wgrad")


def _device_window(fn, reps: int) -> dict:
    """One torch.profiler window over `reps` calls of fn (profile_serve.py's
    measure): the device's own events (kernels, copies) per call and their
    summed time over the window's wall time, the device busy share; the
    heaviest events and the port's kernels (ms per call)."""
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
    device_us = events = 0
    heavy = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            device_us += ev.self_device_time_total
            events += ev.count
            heavy.append((ev.self_device_time_total / 1e3 / reps, ev.count / reps, ev.key[:60]))
    if not events:
        return {"device_busy_share": "not measured", "device_events_per_call": "not measured"}
    heavy.sort(reverse=True)
    port = {k: sum(ms for ms, _, name in heavy if k in name) for k in PORT_KERNEL_NAMES}
    return {"device_ms_per_call": device_us / 1e3 / reps, "device_busy_share": device_us / 1e3 / window_ms,
            "device_events_per_call": events / reps, "window_wall_ms_per_call": window_ms / reps,
            "port_kernels_ms_per_call": {k: v for k, v in port.items() if v > 0},
            "top_events_ms_per_call": [[round(ms, 4), c, name] for ms, c, name in heavy[:10]]}


def check_slot_lists(model, card: str) -> dict:
    """Rows 1 and 2 on capacity-bounded slot lists at the bench frame (tile
    32): padded to the initial capacity rule's 6 slots a Gaussian, and
    overflowing at 3/4 of the pairs, each against its plain version at phase
    4's budgets, the padding rows zero; the overflow's kept pairs equal to
    the CPU binning's (which the tests hold to the JAX package's); the
    reduction's time at the padded capacity; and the ellipse cull on
    against off (pairs kept, binning ms, the frame within CULL_ATOL)."""
    import torch

    from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_tiles, reduce_rows_by_gid
    from freegaussian_tpu_torch.ops.tiles import build_intersections

    width, height = SERVE_WH
    inputs, _ = pixel_stage_inputs(model, bench_camera(width, height, DEVICE))
    m2d, con, chans, opac, depths, radii = inputs
    n = m2d.shape[0]
    total = build_intersections(m2d, radii, depths, width, height, 32).num_isects
    padded, overflow = 6 * n, total * 3 // 4
    out = {"pairs": total, "padded_capacity": padded, "overflow_capacity": overflow}
    for label, cap in (("padded", padded), ("overflow", overflow)):
        _check_forward(inputs, width, height, (32,), (3, 4), frame=label, timed=False, capacity=cap)
        _check_backward(m2d, con, chans, opac, depths, radii, width, height, None, frame=label, tiles=(32,),
                        channels=(5,), capacity=cap)
    card_bins = build_intersections(m2d, radii, depths, width, height, 32, overflow)
    cpu_bins = build_intersections(m2d.cpu(), radii.cpu(), depths.cpu(), width, height, 32, overflow)
    differ = [k for k in ("gauss_ids", "tile_ids", "tile_offsets", "counts", "offsets")
              if not torch.equal(getattr(card_bins, k).cpu(), getattr(cpu_bins, k))]
    kept = int(card_bins.tile_offsets[-1])
    print(f"graphs overflow: capacity {overflow} of {total} pairs, {kept} kept; card vs CPU binning differs in "
          f"{differ or 'nothing'} ({card})")
    if differ or kept != overflow or int(card_bins.num_isects) != total:
        raise AssertionError(f"overflowing binning: {differ}, kept {kept}, num_isects {int(card_bins.num_isects)}")

    # the per-Gaussian reduction (its f64 prefix spans the capacity): at the
    # padded capacity against the exact size, the same rows
    rows = {}
    for label, cap in (("exact", None), ("padded", padded)):
        b = build_intersections(m2d, radii, depths, width, height, 32, cap)
        r = torch.randn(b.gauss_ids.shape[0], 13, device=m2d.device)
        r[b.gauss_ids >= n] = 0.0
        rows[label] = (r, b)
    ms = {label: cuda_ms(lambda r=r, b=b: reduce_rows_by_gid(r, b.gauss_ids, b.offsets, b.counts), reps=10)
          for label, (r, b) in rows.items()}
    out["reduction_ms"] = ms
    print(f"graphs reduction: {ms['padded']:.3f} ms over the padded capacity's {padded} slots against "
          f"{ms['exact']:.3f} ms over the {total} pairs ({card})")

    # the cull, on against off, at the padded capacity
    col = chans[:, :3].contiguous()
    bbox = build_intersections(m2d, radii, depths, width, height, 32, padded)
    culled = build_intersections(m2d, radii, depths, width, height, 32, padded, conics=con, opacities=opac)
    f_bbox = rasterize_tiles(m2d, con, col, opac, radii, bbox.gauss_ids, bbox.tile_offsets, width, height, 32)
    f_cull = rasterize_tiles(m2d, con, col, opac, radii, culled.gauss_ids, culled.tile_offsets, width, height, 32)
    err = max(float((f_cull[i] - f_bbox[i]).abs().max()) for i in (0, 1))
    bin_ms = {label: cuda_ms(lambda kw=kw: build_intersections(m2d, radii, depths, width, height, 32, padded, **kw), reps=10)
              for label, kw in (("off", {}), ("on", dict(conics=con, opacities=opac)))}
    out["cull"] = dict(pairs_off=int(bbox.tile_offsets[-1]), pairs_on=int(culled.tile_offsets[-1]),
                       num_isects_on=int(culled.num_isects), max_abs_diff=err, binning_ms=bin_ms)
    print(f"graphs cull: pairs {out['cull']['pairs_off']} off, {out['cull']['pairs_on']} on; frame max |diff| {err:.3g} "
          f"(budget {CULL_ATOL}); binning {bin_ms['off']:.3f} ms off, {bin_ms['on']:.3f} ms on ({card})")
    if not err <= CULL_ATOL or not out["cull"]["pairs_on"] <= out["cull"]["pairs_off"]:
        raise AssertionError(f"ellipse cull: frame max |diff| {err} > {CULL_ATOL}, or more pairs kept")
    return out


def _hold_graphed(label: str, eager, graphed, card: str) -> dict:
    """The graphed run's logged losses and final state against the eager
    per-step loop's: losses within GRAPH_LOSS_RTOL, every parameter and
    first moment as max |diff| (bit equality predicted), the first moments
    within TRAIN_CHECK_RTOL relative L2."""
    rows = [[r for r in _verb_metrics(t.out_dir.parent)[0]] for t in (eager, graphed)]
    losses = [[(r["step"], r["loss"]) for r in rr] for rr in rows]
    if [s for s, _ in losses[0]] != [s for s, _ in losses[1]]:
        raise AssertionError(f"{label}: logged steps {losses}")
    loss_diff = max(abs(a - b) / max(abs(b), 1e-12) for (_, a), (_, b) in zip(losses[1], losses[0]))
    se, sg = eager.state, graphed.state
    param_diff = max(float((sg.params[k] - se.params[k]).detach().abs().max()) for k in se.params)
    mu_diff = max(float((sg.opt_states[g].mu[k] - st.mu[k]).abs().max()) for g, st in se.opt_states.items() for k in st.mu)
    mu_l2 = max(_rel_l2(sg.opt_states[g].mu[k], st.mu[k]) for g, st in se.opt_states.items() for k in st.mu)
    out = dict(losses_graphed=losses[1], losses_eager=losses[0], loss_max_rel_diff=loss_diff,
               params_max_abs_diff=param_diff, first_moments_max_abs_diff=mu_diff, first_moments_max_rel_l2=mu_l2,
               bit_equal=loss_diff == param_diff == mu_diff == 0.0, alive_equal=bool((sg.alive == se.alive).all()))
    print(f"graphs {label} check: {json.dumps(out)} ({card})")
    if not (loss_diff <= GRAPH_LOSS_RTOL and mu_l2 <= TRAIN_CHECK_RTOL and out["alive_equal"]):
        raise AssertionError(f"{label}: graphed vs eager outside the step's budgets: {out}")
    return out


def _per_step(v, steps: int):
    """A profiler window's figures per call (a number, a dict of them, or
    [ms, count, name] rows) over the `steps` steps of the call."""
    if isinstance(v, dict):
        return {k: _per_step(x, steps) for k, x in v.items()}
    if isinstance(v, list):
        return [[round(ms / steps, 4), c / steps, name] for ms, c, name in v]
    return v / steps


def _time_graphed(label: str, eager, graphed, steps: int, card: str) -> dict:
    """Wall ms per step of `steps` more steps of each (host clock to a
    synchronize, in turns: eager, graphed, graphed, eager), then one
    profiler window of one chunk each: busy share and device events per
    step."""
    import torch

    walls = {"eager": [], "graphed": []}
    for name in ("eager", "graphed", "graphed", "eager"):
        t = eager if name == "eager" else graphed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(steps)
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3 / steps)
    out = {name: {"wall_ms_per_step": w} for name, w in walls.items()}
    for name, t in (("eager", eager), ("graphed", graphed)):
        window = _device_window(lambda t=t: t.train(GRAPH_CHUNK), 1)
        for k, v in window.items():
            keep = isinstance(v, str) or k == "device_busy_share"
            out[name][k.replace("_per_call", "_per_step")] = v if keep else _per_step(v, GRAPH_CHUNK)
    out["capture_s"] = graphed.graph_stats["capture_s"]
    out["captures"] = graphed.graph_stats["captures"]
    print(f"graphs {label} time: {json.dumps(out)} ({card})")
    return out


def bench_inputs(tmp: Path, data: Path, model) -> dict:
    """The bench scene moved into phase 13's dataset frame as a checkpoint
    directory (`bench_scene_checkpoint`, N = 1e5 at its step, written
    through a verb trainer of capacity VERB_CAPACITY from a small random
    init) and a seeded cluster mask over its live rows, for phases 24 and
    25; `base` holds the `train` verb's flags over the dataset."""
    import torch

    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.preprocess.clustering import save_gaussian_mask

    base = ["--data", str(data), "--config", str(HERE / "configs/sim/base.yaml"), "--capacity", str(VERB_CAPACITY),
            "--device", DEVICE]
    small = _write(tmp / "graphs_small.yaml", "num_random: 1000\nvis: jsonl\n")
    scratch = cli._build_trainer(cli.build_parser().parse_args(["train", *base, "--scene-config", str(small)]), False)
    ckpt = bench_scene_checkpoint(scratch, model, tmp / "graphs_bench")
    alive = scratch.state.alive.cpu()
    del scratch
    live_mask = synthetic_mask(model.params["means"].detach()[model.alive].cpu().numpy())
    full = torch.zeros((alive.shape[0], live_mask.shape[1]), dtype=torch.bool)
    full[alive] = torch.from_numpy(live_mask)
    mask = tmp / f"graphs_mask_{live_mask.shape[0]}x{live_mask.shape[1]}.npy"
    save_gaussian_mask(mask, full, alive)
    return {"base": base, "ckpt": ckpt, "mask": mask}


def bench_trainer_argv(tmp: Path, data: Path, bench: dict, model, label: str, control: bool, chunk: int,
                       steps: int, extra: str = "") -> list:
    """The `train` (stage 1, `--load` the bench checkpoint) or
    `train-control` (over it, with the bench mask) verb's arguments for a
    trainer at the bench point: `steps` steps, logs every GRAPH_CHUNK, no
    eval or save cadence, `scan_chunk` `chunk`, the binning's capacity the
    rule's 6 slots a Gaussian; `extra` adds lines under pipeline.model."""
    n = int(model.alive.shape[0])
    text = (f"max_num_iterations: {steps}\nnum_random: 1000\nsteps_per_log: {GRAPH_CHUNK}\n"
            f"steps_per_save: 0\nsteps_per_eval_image: 0\nsteps_per_eval_all_images: 0\nvis: jsonl\n"
            f"output_dir: {tmp / f'{label}_{chunk}'}\nscan_chunk: {chunk}\n"
            f"pipeline:\n  model:\n    isect_capacity: {6 * n}\n{extra}")
    over = _write(tmp / f"{label}_{chunk}.yaml", text)
    if not control:
        return ["train", *bench["base"], "--scene-config", str(over), "--load", str(bench["ckpt"])]
    return ["train-control", "--data", str(data), "--config", str(HERE / "configs/control/sim/base.yaml"),
            "--scene-config", str(over), "--stage1-checkpoint", str(bench["ckpt"]),
            "--gaussian-mask", str(bench["mask"]), "--deform-impl", STAGE2_IMPL, "--capacity", str(VERB_CAPACITY),
            "--device", DEVICE]


def phase_graphs(tmp: Path, data: Path, model, card: str, bench: dict) -> dict:
    """Phase 24 (`graphs` lines): `check_slot_lists`, then stage 1 and stage
    2 with `scan_chunk` GRAPH_CHUNK (two chunks, each chunk CUDA-graph
    replays; stage 1 with one refinement inside the second chunk) against
    the eager per-step loop from the same state. Both are built as the
    `train` and `train-control` verbs build them over phase 13's dataset
    and `--load` the bench scene moved into its frame
    (`bench_scene_checkpoint`: N = 1e5 at step 30000, 640x480, tile 32,
    capacity 2^18, the binning's capacity the rule's 6 slots a Gaussian;
    stage 2 over that checkpoint with a seeded cluster mask, deform_impl
    "pallas"): losses and state held by `_hold_graphed`, then the wall ms
    per step, busy share, device events per step and capture time of each
    (`_time_graphed`). Launches are zeroed before each graphed run and read
    after; a replay's launches are its graph's captured launches
    (`trainer.graph_stats`), which the counters do not see."""
    import torch

    from freegaussian_tpu_torch import cli

    out = {"slots": check_slot_lists(model, card)}
    launch_total = {k: 0 for k in launches()}
    for label, control in (("stage1", False), ("stage2", True)):
        def argv_for(chunk, label=label, control=control):
            refine_at = model.step + GRAPH_REFINE_AT
            extra = "" if control else f"    refine_start: {refine_at}\n    refine_every: {GRAPH_REFINE_AT}\n"
            return bench_trainer_argv(tmp, data, bench, model, f"graphs_{label}", control, chunk, GRAPH_STEPS, extra)

        # `scan_chunk` 0 and GRAPH_CHUNK from one seed: the same initial state and frames
        eager, graphed = (cli._build_trainer(cli.build_parser().parse_args(argv_for(chunk)), control)
                          for chunk in (0, GRAPH_CHUNK))
        eager.train(GRAPH_STEPS)
        torch.cuda.synchronize()
        zero_launches()
        graphed.train(GRAPH_STEPS)
        torch.cuda.synchronize()
        replayed = dict(graphed.graph_stats["replayed_launches"])
        counts = {k: v + replayed.get(k, 0) for k, v in launches().items()}
        print(f"graphs {label} launches: eager warm-up steps {json.dumps(launches())}, replays "
              f"{graphed.graph_stats['replays']} adding {json.dumps(replayed)} ({card})")
        want = ("rasterize_fwd", "rasterize_bwd", "adam") + (("field_fwd", "field_bwd") if control else ("deform_fwd", "deform_bwd"))
        stats = graphed.graph_stats
        # each graph's first step is its eager warm-up, every other step a replay
        if graphed.device.type == "cuda" and not (
            all(counts[k] > 0 and replayed.get(k, 0) > 0 for k in want)
            and stats["captures"] >= 1 and stats["replays"] + stats["captures"] == GRAPH_STEPS
        ):
            raise AssertionError(f"graphs {label}: launches {counts}, replayed {replayed}, {stats}")
        for k, v in counts.items():
            launch_total[k] += v
        out[label] = {"check": _hold_graphed(label, eager, graphed, card),
                      "time": _time_graphed(label, eager, graphed, GRAPH_STEPS, card)}
        del eager, graphed
    out["launches"] = launch_total
    return out


# Phase 25, the eval sweep
SWEEP_ROUNDS = 5  # timed eval_all calls of the sweep and of the loop, in turns
SWEEP_MAX_DIFF = 1e-5  # each frame's PSNR and SSIM, the sweep against the loop on the same trainer


def _loop_eval(trainer) -> dict:
    """`eval_all` down its per-frame loop (the path a mixed-size split
    takes): the arena hook answers None for this call."""
    trainer._eval_arena = lambda dm, max_images: None
    try:
        return trainer.eval_all()
    finally:
        del trainer._eval_arena


def phase_sweep(tmp: Path, data: Path, model, card: str, bench: dict) -> dict:
    """Phase 25 (`sweep` lines): the eval sweep of stage 1 and stage 2 at the
    bench point, on trainers built as phase 24's (the verbs' trainers over
    phase 13's 8-frame 640x480 dataset with the bench scene loaded, 1e5
    Gaussians, the binning's capacity 6e5), with LPIPS off. The first
    `eval_all` captures the sweep's graph (its first frame the eager
    warm-up), the second replays it 8 times; launches are zeroed before
    each and read after (a replay adds its graph's captured launches to the
    counters). Each frame's PSNR and SSIM against the per-frame loop's on
    the same trainer; then eval_all with the sweep and with the loop in
    turns, SWEEP_ROUNDS each (host clock around the call, which ends in its
    host copies), and one profiler window of each."""
    import torch

    from freegaussian_tpu_torch import cli
    from freegaussian_tpu_torch.models.metrics import lpips_available
    from freegaussian_tpu_torch.models.splat_model import psnr
    from freegaussian_tpu_torch.models.ssim import ssim

    out = {}
    launch_total = dict.fromkeys(launches(), 0)
    with lpips_weights_env(tmp / "sweep_no_lpips_weights.npz"):
        if lpips_available(DEVICE):
            raise AssertionError("sweep: LPIPS weights load, so eval_all would take its loop")
        for label, control in (("stage1", False), ("stage2", True)):
            argv = bench_trainer_argv(tmp, data, bench, model, f"sweep_{label}", control, 0, 0)
            t = cli._build_trainer(cli.build_parser().parse_args(argv), control)
            n = DATA_FRAMES
            want = (_want_launches(rasterize_fwd=n, field_fwd=3 * n) if control
                    else _want_launches(rasterize_fwd=n, deform_fwd=n))
            calls = {}
            for call in ("first", "warm"):
                torch.cuda.synchronize()
                zero_launches()
                t0 = time.perf_counter()
                report = t.eval_all()
                calls[call] = {"wall_s": time.perf_counter() - t0, "fps": report["fps"], "launches": launches(),
                               "replays": t.eval_graph_stats["replays"]}
                for k, v in calls[call]["launches"].items():
                    launch_total[k] += v
            stats = dict(t.eval_graph_stats)
            dm = t.eval_datamanager or t.datamanager
            table = t._eval_sweep(t._eval_arena(dm, None)).run()
            with torch.no_grad():
                loop = np.array([(float(psnr(rgb, gt)), float(ssim(rgb, gt))) for rgb, gt in
                                 ((t._render_rgb(cam), b["image"][..., :3]) for cam, b in dm.eval_frames())])
            diff = np.abs(table - loop).max(0)
            print(f"sweep {label}: {n} frames at {SERVE_WH[0]}x{SERVE_WH[1]}; graphs captured {stats['captures']} "
                  f"({stats['capture_s']:.3f} s), replays {calls['first']['replays']} in the first call, "
                  f"{calls['warm']['replays'] - calls['first']['replays']} in the warm one; launches first "
                  f"{json.dumps(calls['first']['launches'])}, warm {json.dumps(calls['warm']['launches'])}; per frame "
                  f"psnr {table[:, 0].round(4).tolist()}, against the loop max |diff| psnr {diff[0]:.3g}, ssim "
                  f"{diff[1]:.3g} (budget {SWEEP_MAX_DIFF}); mean psnr {report['psnr']:.4f}, ssim {report['ssim']:.4f} "
                  f"({card})")
            min_psnr = EVAL_MIN_PSNR if not control else -np.inf
            ok = (diff.max() <= SWEEP_MAX_DIFF and report["psnr"] >= min_psnr and report["lpips_available"] is False
                  and table.shape == (n, 2))
            if t.device.type == "cuda":  # on the CPU (a rehearsal) the frames run eagerly, uncounted
                ok = ok and (stats["captures"] == 1 and calls["first"]["replays"] == n - 1
                             and calls["warm"]["replays"] - calls["first"]["replays"] == n
                             and calls["first"]["launches"] == want and calls["warm"]["launches"] == want)
            if not ok:
                raise AssertionError(f"sweep {label}: {stats}, calls {calls}, want launches {want}, diff {diff}, "
                                     f"report {report}")

            walls = {"sweep": [], "loop": []}
            for r in range(SWEEP_ROUNDS):
                for path in (("sweep", "loop") if r % 2 == 0 else ("loop", "sweep")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    (t.eval_all if path == "sweep" else lambda: _loop_eval(t))()
                    walls[path].append(time.perf_counter() - t0)
            if t.eval_graph_stats["captures"] != stats["captures"]:
                raise AssertionError(f"sweep {label}: captured again in the timed calls: {t.eval_graph_stats}")
            timing = {path: {"fps": [n / w for w in ws], "median_fps": n / statistics.median(ws)}
                      for path, ws in walls.items()}
            timing["first_call"] = {"fps": n / calls["first"]["wall_s"], "wall_s": calls["first"]["wall_s"]}
            timing["capture_s"] = stats["capture_s"]
            for path, fn in (("sweep", t.eval_all), ("loop", lambda: _loop_eval(t))):
                window = _device_window(fn, 2)
                timing[path].update(window)  # per call: a sweep of n frames
            print(f"sweep {label} time: {json.dumps(timing)} ({card})")
            out[label] = {"calls": calls, "max_abs_diff": diff.tolist(), "time": timing}
            del t
    out["launches"] = launch_total
    return out


def _write(path: Path, text: str) -> Path:
    path.write_text(text)
    return path


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


ADAM_CAPACITY = 2**19  # the training cells' Gaussian capacity
ADAM_LIVE = 100_000
ADAM_REPS = 50


def phase_adam(card: str) -> dict:
    """Phase 26: Adam's kernel at the training cells' shapes against the
    plain chain (bit for bit) and its bound, with `torch._fused_adam_` as a
    yardstick."""
    import torch

    from freegaussian_tpu_torch.engine.train_step import GAUSSIAN_GROUPS
    from freegaussian_tpu_torch.models.fields import ControlField, DeformField
    from freegaussian_tpu_torch.ops import adam_cuda
    from freegaussian_tpu_torch.ops.adam_cuda import AdamGroup, adam_plain, adam_step

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    n = ADAM_CAPACITY
    shapes = {"means": (3,), "scales": (3,), "quats": (4,), "features_dc": (3,), "features_rest": (45,), "opacities": (1,)}
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    alive[:ADAM_LIVE] = True
    out = {}
    for label, field_cls in (("deform", DeformField), ("control", ControlField)):
        def rand(shape, scale):
            return torch.randn(shape, generator=gen, device=dev) * scale

        def four(shape):
            return [rand(shape, 0.1), rand(shape, 1e-3), rand(shape, 1e-3), rand(shape, 1e-6).abs()]

        gauss = [four((n,) + shapes[k]) for k in GAUSSIAN_GROUPS]
        # the SH coefficients' gradients as the step gets them: slices of one (n, 16, 3) gradient
        dc, rest = GAUSSIAN_GROUPS.index("features_dc"), GAUSSIAN_GROUPS.index("features_rest")
        sh = torch.cat([gauss[dc][1][:, None, :], gauss[rest][1].view(n, 15, 3)], dim=1)
        gauss[dc][1], gauss[rest][1] = sh[:, 0, :], sh[:, 1:, :].reshape(n, 45)
        weights = [four(tuple(p.shape)) for _, p in field_cls().named_parameters()]
        # the step's scalars at step 16801 of 30000 (bias corrections ~1)
        scal = (-1.6e-4 * 5 * 2 * 0.01 ** (16801 / 30000), 1.0, float(1 / (1 - 0.999 ** 16802)))

        def groups(state):
            g_groups = [AdamGroup(0.9, 0.999, 1e-15, scal, [tuple(t)], masked=True) for t in state[: len(gauss)]]
            return g_groups + [AdamGroup(0.9, 0.999, 1e-15, scal, [tuple(t) for t in state[len(gauss):]])]

        state = gauss + weights
        plain = [[t if j == 1 else t.clone() for j, t in enumerate(ts)] for ts in state]  # the same gradients
        before = adam_cuda.LAUNCHES["adam"]
        adam_step(groups(state), alive)
        adam_plain(groups(plain), alive)
        torch.cuda.synchronize()
        if adam_cuda.LAUNCHES["adam"] - before != 1:
            raise AssertionError(f"adam {label}: {adam_cuda.LAUNCHES['adam'] - before} launches for one step")
        for ts_k, ts_p in zip(state, plain):
            for j in (0, 2, 3):
                if not torch.equal(ts_k[j].view(torch.int32), ts_p[j].view(torch.int32)):
                    raise AssertionError(f"adam {label}: the kernel differs from the plain chain at {tuple(ts_k[j].shape)}")
        elements = sum(ts[0].numel() for ts in state)
        bytes_ = 28 * elements + n  # p, g, mu, nu read and p, mu, nu written once; the mask once
        bound_ms = bytes_ / PEAK_BYTES * 1e3
        ms = graph_ms(lambda: adam_step(groups(state), alive), ADAM_REPS)
        plain_ms = graph_ms(lambda: adam_plain(groups(plain), alive), ADAM_REPS)
        steps = [torch.zeros((), device=dev) for _ in plain]
        grads = [t[1].contiguous() for t in plain]  # the library's multi-tensor apply takes dense tensors

        def library():
            torch._fused_adam_(
                [t[0] for t in plain], grads, [t[2] for t in plain], [t[3] for t in plain], [], steps,
                lr=1.6e-4, beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-15, amsgrad=False, maximize=False,
            )

        library_ms = graph_ms(library, ADAM_REPS)
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bytes": bytes_,
               "elements": elements, "tensors": len(state)}
        out[label] = row
        print(f"adam {label}: {len(state)} tensors, {elements} elements, {bytes_ / 1e9:.4f} GB; kernel {ms:.4f} ms "
              f"({bound_ms / ms * 100:.1f}% of the bound {bound_ms:.4f} ms, {bytes_ / ms / 1e6:.0f} GB/s); plain "
              f"{plain_ms:.4f} ms; torch._fused_adam_ {library_ms:.4f} ms; kernel bit-equal to plain; {card}")
    return out


def main():
    preflight()
    import torch

    t_start = time.perf_counter()
    card = phase_device()
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
        phase_viewer_verb(data, verb, control_verb)
        pipeline = phase_pipeline(Path(tmp), data, verb, model, card)
        del verb["trainer"], control_verb["trainer"]
        captures = phase_captures(Path(tmp), model, train["median_step_ms"], card)
        t_new = time.perf_counter()
        extras = phase_extras(Path(tmp), data, model, card)
        t_extras = time.perf_counter()
        phase_bands(model, card)
        t_bands = time.perf_counter()
        parallel = phase_parallel(model, ckpt)
        t_parallel = time.perf_counter()
        bench = bench_inputs(Path(tmp), data, model)
        graphs = phase_graphs(Path(tmp), data, model, card, bench)
        t_graphs = time.perf_counter()
        sweep = phase_sweep(Path(tmp), data, model, card, bench)
        t_sweep = time.perf_counter()
        adam = phase_adam(card)
        print(f"phases 21-26: extras {t_extras - t_new:.1f} s, bands {t_bands - t_extras:.1f} s, "
              f"parallel {t_parallel - t_bands:.1f} s, graphs {t_graphs - t_parallel:.1f} s, "
              f"sweep {t_sweep - t_graphs:.1f} s, adam {time.perf_counter() - t_sweep:.1f} s")
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
    # row 10: the training steps' Adam update, once a step in phases 7 and 11; phase 26's timing (its launches apart)
    row = adam["deform"]
    records.append({
        "name": "adam", "route": "cuda", "source": "freegaussian_tpu_torch/csrc/adam.cu",
        "replaces": "none: optax's update, fused by XLA", "launches": train["launches"]["adam"] + train2["launches"]["adam"],
        "max_abs_err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": "bytes",
        "library_ms": row["library_ms"],
    })
    assert [r["name"] for r in records] == list(launches())
    # phase 19's verbs (rows 1, 6 and 8, the 5 control steps' backwards; row 10); phases 20, 21 and 23's (rows 1, 2, 8,
    # 9, 10); phase 24's graphed chunks (rows 1, 2, 8, 9 in stage 1, 1, 2, 6, 7 in stage 2, row 10 in both; replays
    # included); phase 25's eval sweeps (rows 1 and 8 in stage 1, 1 and 6 in stage 2; replays included)
    for r in records:
        r["launches"] += sum(run["launches"][r["name"]] for run in (pipeline, captures, extras, parallel, graphs, sweep))
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
