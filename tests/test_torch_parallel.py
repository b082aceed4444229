"""The port's multi-GPU path on the CPU: band rendering, the differentiable
all-gather and halo exchange, and `make_parallel_train_step` over gloo in 2
or 4 processes (`torch_parallel_worker.py`, spawned as
tests/test_distributed_multiprocess.py spawns its workers: a free port, a
timeout), held against the JAX package's `make_parallel_train_step` on the
conftest's virtual CPU mesh at the same mesh, state and random draws, and
against the port's own single-process step.

Both packages run the dense reference compositor (the JAX multi-chip tests'
backend; the absgrad sink rides means2d on both). Tolerances: against the
JAX step, the single-step parity budgets (tests/test_torch_train_step.py:
losses rtol 1e-5 at the first step, 1e-4 after; parameters
`_assert_params_close`); against the port's single step, the JAX package's
own multi-chip budgets (tests/test_parallel.py: loss and SSIM rtol 2e-5,
parameters rtol 5e-4 / atol 5e-6, absgrad statistics rtol 5e-3); between
ranks, bit-equal parameters.
"""

import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models.densify import DensifyConfig as JDensifyConfig
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu.parallel import make_mesh as j_make_mesh
from freegaussian_tpu.parallel import make_parallel_train_step as j_make_parallel_train_step
from freegaussian_tpu.parallel import replicate_state as j_replicate_state
from freegaussian_tpu.parallel import stack_cameras as j_stack_cameras
from freegaussian_tpu_torch.engine.checkpoints import save_checkpoint
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
from freegaussian_tpu_torch.engine.train_step import GAUSSIAN_GROUPS, make_train_step
from freegaussian_tpu_torch.models.densify import DensifyConfig
from freegaussian_tpu_torch.models.splat_model import SplatConfig
from freegaussian_tpu_torch.ops.rasterize import rasterization
from test_torch_train_step import LR, _assert_params_close
from torch_port_helpers import (
    bench_like_scene, camera_arrays, gaussian_scene_3d, jax_camera, jax_step_draws, torch_camera, train_state_pair,
)

REPO = Path(__file__).resolve().parent.parent
CAPACITY = 64
MODEL = dict(warm_up=0, sh_degree=3, backend="reference", background_color="random", tile_size=16, deform_bf16=False)
NO_REFINE = dict(refine_start=10**9)
REFINE = dict(refine_start=1, refine_every=2, densify_grad_thresh=1e-6, stop_screen_size_at=0, reset_alpha_every=10**6)
FLOW = dict(flow_loss_weight=0.05, flow_3d_loss_weight=0.5)


# --- band rendering (one process) -------------------------------------------------


@pytest.mark.parametrize("bands,tile", [(2, 16), (3, 16), (3, 32), (2, 32)])
def test_band_rendering_stitched_equals_full_frame(bands, tile):
    """`rasterization` of each band (`tile_origin_y`, `proj_height`) on the
    plain compositor, stitched, equals the full frame; the per-Gaussian
    gradients summed over the bands equal the full frame's, and so does the
    absgrad sink's where the band height is a multiple of the tile size
    (absgrad sums |d means2d| per tile: 48-row bands at tile 32 cut tiles);
    `info` stays in full-frame coordinates."""
    W, H = 48, 96
    rng = np.random.default_rng(bands)
    params, alive = gaussian_scene_3d(n=120, seed=bands)
    arrs = camera_arrays(width=W, height=H, focal=60.0)
    cam = torch_camera(arrs)
    weights = torch.tensor(rng.normal(size=(H, W, 4)).astype(np.float32))

    def run(origin, height):
        leaves = {k: torch.tensor(params[k], requires_grad=True) for k in ("means", "scales", "quats", "opacities")}
        colors = torch.tensor(params["features_dc"], requires_grad=True)
        sink = torch.zeros((len(alive), 2), requires_grad=True)
        render, alpha, info = rasterization(
            leaves["means"], leaves["quats"], torch.exp(leaves["scales"]), torch.sigmoid(leaves["opacities"][:, 0]),
            colors, cam.viewmat[None], cam.K[None], W, height, tile_size=tile, render_mode="RGB+ED",
            alive=torch.tensor(alive), means2d_sink=sink, tile_origin_y=origin, proj_height=H if height != H else None,
        )
        out = torch.cat([render[0, ..., :3], alpha[0]], dim=-1)
        torch.sum(out * weights[origin:origin + height]).backward()
        grads = {k: v.grad for k, v in leaves.items()} | {"colors": colors.grad, "absgrad": sink.grad}
        return out.detach(), render[0, ..., 3:].detach(), grads, info

    full, full_depth, full_grads, full_info = run(0, H)
    hs = H // bands
    parts = [run(b * hs, hs) for b in range(bands)]
    torch.testing.assert_close(torch.cat([p[0] for p in parts]), full, rtol=0, atol=2e-5)
    alpha_full = full[..., 3:]
    seen = alpha_full > 1e-3  # expected depth is accumulated depth / alpha
    torch.testing.assert_close(torch.cat([p[1] for p in parts])[seen], full_depth[seen], rtol=1e-5, atol=1e-5)
    for k, g in full_grads.items():
        if k == "absgrad" and hs % tile:
            continue
        summed = sum(p[2][k] for p in parts)
        torch.testing.assert_close(summed, g, rtol=1e-3, atol=1e-4, msg=lambda m: f"{k}: {m}")
    for p in parts:
        torch.testing.assert_close(p[3].means2d, full_info.means2d)
        assert torch.equal(p[3].radii, full_info.radii)
    # the binning clamps each Gaussian's tile rows to the band: aligned bands split the frame's slots
    band_isects = sum(p[3].num_isects for p in parts)
    assert band_isects == full_info.num_isects > 0 if hs % tile == 0 else band_isects >= full_info.num_isects > 0


def test_band_rendering_on_the_compositor_path():
    """The same on the tile compositor's path (the port's `auto` backend:
    the kernels' plain versions here) at a bench-like screen scene: the
    binning sees band coordinates, Gaussians above and below the band
    included."""
    from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_pixels

    W, H, tile = 64, 64, 16
    means2d, conics, colors, opac, depths, radii = (torch.tensor(a) for a in bench_like_scene(n=600, width=W, height=H))
    full, full_alpha, n_full = rasterize_pixels(means2d, conics, colors, opac, depths, radii.float(), W, H, tile_size=tile)
    stitched, n_bands = [], 0
    for b in range(2):
        shifted = means2d - torch.tensor([0.0, 32.0 * b])
        img, alpha, n = rasterize_pixels(shifted, conics, colors, opac, depths, radii.float(), W, 32, tile_size=tile)
        stitched.append(torch.cat([img, alpha], -1))
        n_bands += n
    torch.testing.assert_close(torch.cat(stitched), torch.cat([full, full_alpha], -1), rtol=0, atol=2e-5)
    assert n_bands == n_full


# --- multi-process cases -------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(case_dir, world):
    port = _free_port()
    env = {"PYTHONPATH": f"{REPO}:{REPO / 'tests'}", "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(case_dir),
           "OMP_NUM_THREADS": "1"}
    return [
        subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_parallel_worker.py"), str(case_dir), str(r),
                          str(world), str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)
    ]


def _join(procs, case_dir):
    outs = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [torch.load(case_dir / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _start(tmp_path, *, data, tile, hw, steps, densify, model=(), with_flow=False, with_refine=False,
           variants=None, inject_draws=True, seed=0):
    """Write a case (a seeded scene, cameras, images, flows, draws from the
    JAX state's keys) and start its ranks. Returns (procs, case)."""
    H, W = hw
    params, alive = gaussian_scene_3d(n=50, seed=seed, capacity=CAPACITY)
    jstate, tstate, field, j_opts = train_state_pair(scene=(params, alive), seed=seed)
    rng = np.random.default_rng(seed + 11)
    cams = [camera_arrays(width=W, height=H, focal=50.0, eye=(0.8 - 0.3 * i, 0.5, 4.0), time=0.6 - 0.2 * i)
            for i in range(data)]
    cams0 = [dict(c, time=np.float32(0.1)) for c in cams]
    images = rng.uniform(size=(data, H, W, 3)).astype(np.float32)
    flows = rng.normal(scale=0.5, size=(data, H, W, 2)).astype(np.float32)
    depth0s = np.full((data, H, W, 1), 3.0, np.float32)
    keys, draws = jstate.key, []
    for _ in range(steps):
        draws.append(jax_step_draws(keys, CAPACITY))
        keys = jax.random.split(keys, 3)[0]
    model = dict(MODEL, **dict(model))
    case = dict(
        data=data, tile=tile, hw=hw, steps=steps, model=dict(model, deform_impl="headsfused"), densify=densify,
        with_flow=with_flow, with_refine=with_refine, variants=variants or {"base": {}}, num_train_data=4,
        cams=cams, cams0=cams0, images=torch.tensor(images), flows=torch.tensor(flows), depth0s=torch.tensor(depth0s),
        draws=draws if inject_draws else None, deform_depth=2, deform_width=32,
    )
    case_dir = tmp_path / "case"
    (case_dir / "ckpt").mkdir(parents=True)
    torch.save(case, case_dir / "case.pt")
    save_checkpoint(case_dir / "ckpt", 0, tstate)
    procs = _spawn(case_dir, data * tile)
    inputs = dict(jstate=jstate, tstate=tstate, field=field, j_opts=j_opts, images=images, flows=flows,
                  depth0s=depth0s, cams=cams, cams0=cams0, model=model, case_dir=case_dir)
    return procs, case, inputs


def _jax_parallel(case, inp, **kw):
    """The JAX package's step on the virtual mesh, same state and inputs."""
    mesh = j_make_mesh(data=case["data"], tile=case["tile"])
    step = j_make_parallel_train_step(
        JConfig(**inp["model"]), JDensifyConfig(**case["densify"]), inp["j_opts"], inp["field"].apply,
        num_train_data=case["num_train_data"], mesh=mesh, image_hw=case["hw"], with_refine=case["with_refine"],
        with_flow=case["with_flow"], **kw,
    )
    state = j_replicate_state(inp["jstate"], mesh)
    args = [j_stack_cameras([jax_camera(c) for c in inp["cams"]]), jnp.asarray(inp["images"])]
    if case["with_flow"]:
        args += [j_stack_cameras([jax_camera(c) for c in inp["cams0"]]), jnp.asarray(inp["flows"]),
                 jnp.asarray(inp["depth0s"])]
    metrics = []
    for _ in range(case["steps"]):
        state, m = step(state, *args, sh_degree_now=3)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _single_steps(case, inp):
    """The port's single-process step on camera 0's full frame."""
    step = make_train_step(SplatConfig(**inp["model"], deform_impl="headsfused"), DensifyConfig(**case["densify"]),
                           make_optimizers(OptimizersConfig(max_steps=1000)), case["num_train_data"])
    state = inp["tstate"]
    batch = {"image": torch.tensor(inp["images"][0])}
    cam0 = None
    if case["with_flow"]:
        batch.update(flow=torch.tensor(inp["flows"][0]), depth0=torch.tensor(inp["depth0s"][0]))
        cam0 = torch_camera(inp["cams0"][0])
    metrics = []
    for i in range(case["steps"]):
        state, m = step(state, torch_camera(inp["cams"][0]), batch, 3, camera0=cam0, draws=case["draws"][i])
        metrics.append({k: float(v) for k, v in m.items() if k != "refine"})
    return state, metrics


def _assert_ranks_equal(results):
    for r, res in enumerate(results[1:], 1):
        for variant, v in res.items():
            for k, p in v["params"].items():
                assert torch.equal(p, results[0][variant]["params"][k]), f"rank {r} {variant} {k}"
            assert torch.equal(v["alive"], results[0][variant]["alive"])
            for k, p in v["deform"].items():
                assert torch.equal(p, results[0][variant]["deform"][k]), f"rank {r} {variant} deform {k}"


def _assert_matches_jax(res, jstate, jmetrics, steps):
    for i, (tm, jm) in enumerate(zip(res["metrics"], jmetrics)):
        for key in ("loss", "main_loss", "l1", "ssim", "psnr", "flow_2d", "flow_3d"):
            if key in jm:
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5 if i == 0 else 1e-4, atol=1e-7,
                                           err_msg=f"step {i} {key}")
        assert tm["gaussian_count"] == jm["gaussian_count"] and tm["num_isects"] == jm["num_isects"]
    np.testing.assert_array_equal(res["alive"].numpy(), np.asarray(jstate.alive))
    for k in GAUSSIAN_GROUPS:
        _assert_params_close(k, res["params"][k].numpy(), np.asarray(jstate.params[k]), LR[k], steps)
    for k in ("xys_grad_norm", "vis_counts", "max_2dsize"):
        np.testing.assert_allclose(res["densify"][k].numpy(), np.asarray(getattr(jstate.densify, k)),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


CASES = {
    # data parallel: two cameras, whole frames
    "dp": dict(data=2, tile=1, hw=(32, 32), steps=2, densify=NO_REFINE),
    # four bands of 16 rows at tile 16, primitive-sharded: the single-GPU step's objective
    "tile4": dict(data=1, tile=4, hw=(64, 32), steps=1, densify=NO_REFINE),
    # both axes, refine on
    "dp_tile": dict(data=2, tile=2, hw=(32, 32), steps=3, densify=REFINE, with_refine=True),
    # the flow losses over four bands
    "flow": dict(data=1, tile=4, hw=(64, 32), steps=1, densify=NO_REFINE, model=FLOW, with_flow=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_parallel_step_matches_jax_and_the_single_step(tmp_path, name):
    case_kw = CASES[name]
    procs, case, inp = _start(tmp_path, **case_kw)
    jstate, jmetrics = _jax_parallel(case, inp)  # while the ranks run
    single = _single_steps(case, inp) if case["data"] == 1 else None
    results = _join(procs, inp["case_dir"])
    _assert_ranks_equal(results)
    res = results[0]["base"]
    assert res["step"] == case["steps"]
    _assert_matches_jax(res, jstate, jmetrics, case["steps"])
    if single is not None:
        sstate, smetrics = single
        for key in ("loss", "ssim", "flow_2d", "flow_3d"):
            if key in smetrics[0]:
                np.testing.assert_allclose(res["metrics"][0][key], smetrics[0][key], rtol=2e-5, err_msg=key)
        for k in ("means", "scales", "opacities"):
            np.testing.assert_allclose(res["params"][k].numpy(), sstate.params[k].detach().numpy(),
                                       rtol=5e-4, atol=5e-6, err_msg=k)
        np.testing.assert_allclose(res["densify"]["xys_grad_norm"].numpy(), sstate.densify.xys_grad_norm.numpy(),
                                   rtol=5e-3, atol=1e-7)
    if name == "dp_tile":
        assert any("refine" in m for m in res["metrics"]) and max(m["gaussian_count"] for m in res["metrics"]) <= CAPACITY


def _close_to_step(got, want, start, frac, name):
    d = np.abs(got - want)
    step_mag = np.abs(want - start)
    assert float(d.max()) <= frac * float(step_mag.max()) + 1e-6, name


@pytest.mark.parametrize("name", ["refine", "zero1", "zero1_refine", "bf16"])
def test_parallel_step_variants(tmp_path, name):
    """On (data 2, tile 2): refine keeps static shapes with the ranks'
    parameters bit-equal (every rank draws the split samples from its copy
    of the replicated generator); ZeRO-1 gives the replicated update
    (f32 reassociation only) and its gathered moments equal the replicated
    ones; a bf16 gradient reduce stays within a quarter of the step of f32.
    ZeRO-1 and the bf16 reduce also match the JAX step with the same option."""
    densify = REFINE if "refine" in name else NO_REFINE
    variants = {"base": {}}
    if name.startswith("zero1"):
        variants["zero1"] = {"zero1": True}
    if name == "bf16":
        variants["bf16"] = {"grad_reduce_dtype": "bfloat16"}
    procs, case, inp = _start(tmp_path, data=2, tile=2, hw=(32, 32), steps=6 if "refine" in name else 1,
                              densify=densify, with_refine="refine" in name, variants=variants,
                              inject_draws="refine" not in name, seed=3)
    jax_kw = {"zero1": {"zero1": True}, "bf16": {"grad_reduce_dtype": "bfloat16"}}.get(name)
    jax_run = _jax_parallel(case, inp, **jax_kw) if jax_kw else None  # while the ranks run
    results = _join(procs, inp["case_dir"])
    _assert_ranks_equal(results)
    base = results[0]["base"]
    if jax_run is not None:
        _assert_matches_jax(results[0][name], *jax_run, case["steps"])
    counts = [m["gaussian_count"] for m in base["metrics"]]
    assert max(counts) <= CAPACITY and all(np.isfinite(m["loss"]) for m in base["metrics"])
    start = {k: inp["tstate"].params[k].detach().numpy() for k in GAUSSIAN_GROUPS}
    if "refine" in name:
        assert any("refine" in m for m in base["metrics"])
    for variant in variants:
        if variant == "base":
            continue
        other = results[0][variant]
        if variant == "zero1":
            np.testing.assert_allclose(other["metrics"][0]["loss"], base["metrics"][0]["loss"], rtol=1e-6)
            assert [m["gaussian_count"] for m in other["metrics"]] == counts
            for k in GAUSSIAN_GROUPS:
                np.testing.assert_allclose(other["params"][k].numpy(), base["params"][k].numpy(),
                                           rtol=1e-5, atol=1e-7, err_msg=k)
                if "refine" not in name:
                    np.testing.assert_allclose(other["mu"][k].numpy(), base["mu"][k].numpy(), rtol=1e-5, atol=1e-8)
                    np.testing.assert_allclose(other["nu"][k].numpy(), base["nu"][k].numpy(), rtol=1e-5, atol=1e-12)
        else:
            np.testing.assert_allclose(other["metrics"][0]["loss"], base["metrics"][0]["loss"], rtol=1e-6)
            for k in ("means", "opacities"):
                _close_to_step(other["params"][k].numpy(), base["params"][k].numpy(), start[k], 0.25, k)


def test_all_gather_and_halo_backward_are_each_ranks_share(tmp_path):
    """In 4 processes: `all_gather_rows` stacks the shards in rank order and
    its backward gives each rank the sum over ranks of its shard's rows of
    the gathered gradient; the halo exchange of the bands gives each band
    its neighbours' rows (ring order) and its backward returns each row's
    gradient to its owner; a non-contiguous view reduces (NCCL refuses one:
    `_all_reduce` copies to a contiguous tensor)."""
    case_dir = tmp_path / "case"
    case_dir.mkdir()
    torch.save({"kind": "collectives"}, case_dir / "case.pt")
    results = _join(_spawn(case_dir, 4), case_dir)
    world = 4
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(world)]
    ws = [rng.normal(size=(6 * world, 3)).astype(np.float32) for _ in range(world)]
    bands = [rng.normal(size=(8, 2, 3)).astype(np.float32) for _ in range(world)]
    vs = [rng.normal(size=(18, 2, 3)).astype(np.float32) for _ in range(world)]
    gathered = np.concatenate(xs)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["gathered"].numpy(), gathered)
        np.testing.assert_allclose(res["x_grad"].numpy(), sum(w[6 * r:6 * r + 6] for w in ws), rtol=1e-6, atol=1e-6)
        prv, nxt = bands[(r - 1) % world], bands[(r + 1) % world]
        np.testing.assert_array_equal(res["halo"].numpy(), np.concatenate([prv[-5:], bands[r], nxt[:5]]))
        want = vs[r][5:-5].copy()
        want[-5:] += vs[(r + 1) % world][:5]  # my last rows are the next band's rows above it
        want[:5] += vs[(r - 1) % world][-5:]
        np.testing.assert_allclose(res["band_grad"].numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(res["strided_sum"].numpy(), world * np.arange(12.0).reshape(3, 4).T)
