"""The eval sweep (`Trainer.eval_all` without LPIPS or image dumps over an
eval split of one frame size: `_eval_arena` + `_EvalSweep`), on the CPU
against the JAX package's one-dispatch sweep and against the port's own
per-frame loop, in both stages.

Budgets: against the JAX sweep from the same state (carried across by
`train_state_from_jax`) PSNR rtol 1e-4 and SSIM rtol 1e-3, the eval budgets
of tests/test_torch_trainer.py; the JAX side composites with its dense
oracle (`backend="reference"`, for a short compile), which the tile
compositor matches to f32 rounding, and both run the f32 split-linear
fields. Against the port's loop the sweep runs the same operations on the
same values, so each frame's PSNR and SSIM are bit-equal and the means
agree within 1e-6 relative. The cache cases hold that every change the
sweep's graph could not see (a loaded checkpoint, a replaced mask or init
time, the capacity tuner's new config, the warm-up gate) builds a new sweep
whose numbers are the new state's. The one case on the card (marked
`cuda`, it skips here) holds the graphed sweep against the eager loop; the
file imports JAX only inside the two JAX cases, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_eval_sweep.py
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from freegaussian_tpu_torch.engine.control_trainer import ControlTrainer
from freegaussian_tpu_torch.engine.trainer import Trainer, TrainerConfig
from freegaussian_tpu_torch.models.densify import DensifyConfig
from freegaussian_tpu_torch.models.splat_model import SplatConfig, psnr
from freegaussian_tpu_torch.models.ssim import ssim
from freegaussian_tpu_torch.ops.math import resize_image
from freegaussian_tpu_torch.viewer.png import encode_png, read_png

FRAMES, H, W = 6, 32, 48
LIVE = 50
MODEL = dict(warm_up=0, num_downscales=0, tile_size=16, deform_bf16=False, background_color="random",
             deform_head_init_scale=0.1)
REPORT_KEYS = {"psnr", "ssim", "num_rays_per_sec", "fps", "gaussian_count", "lpips", "lpips_available"}


def write_scene(root: Path, n=FRAMES, h=H, w=W):
    """n seeded frames in the synthetic (blender) layout, PNGs written by the
    port's encoder (no imageio), the camera backing off along z, and a
    seeded (LIVE, 2) cluster mask; no val
    split (the 0.9 fraction keeps all of them), so eval runs over these."""
    frames = []
    for i in range(n):
        img = (np.random.default_rng(i).uniform(0, 255, size=(h, w, 3))).astype(np.uint8)
        (root / "images").mkdir(parents=True, exist_ok=True)
        (root / f"images/frame_{i:04d}.png").write_bytes(encode_png(img))
        (root / "mask").mkdir(exist_ok=True)
        mask = np.zeros((h, w, 3), bool)  # the articulation masks the synthetic parser reads
        mask[:, : w // 2, 0] = True
        mask[:, w // 2 :, 1] = i % 2 == 0
        np.save(root / f"mask/{i:04d}.npy", mask)
        c2w = np.eye(4)
        c2w[2, 3] = 4.0 + 0.1 * i
        frames.append({"file_path": f"./images/frame_{i:04d}", "transform_matrix": c2w.tolist()})
    (root / "transforms.json").write_text(json.dumps({"camera_angle_x": 0.7, "frames": frames}))
    mask = np.random.default_rng(0).uniform(size=(LIVE, 2)) < 0.4
    np.save(root / f"gaussian_mask_{LIVE}x2.npy", mask)
    return root


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("sweep_scene"))


@pytest.fixture(autouse=True)
def no_lpips(tmp_path, monkeypatch):
    """No LPIPS weights, whatever ~/.cache holds: the sweep's case."""
    monkeypatch.setenv("FREEGAUSSIAN_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))


def _config(scene, out, model=None, **kw):
    return TrainerConfig(
        data=str(scene), output_dir=str(out), max_num_iterations=1, steps_per_save=0, steps_per_eval_image=0,
        steps_per_eval_all_images=0, steps_per_log=1, capacity=2 * LIVE, num_random=LIVE, seed=5,
        dataparser_kwargs={"interval": 2}, splat=SplatConfig(**(model or MODEL)),
        densify=DensifyConfig(refine_start=10**9), **kw,
    )


def _trainer(scene, out, stage, model=None, device="cpu", **kw):
    cfg = _config(scene, out, model, **kw)
    if stage == 2:
        return ControlTrainer(cfg, gaussian_mask_path=scene / f"gaussian_mask_{LIVE}x2.npy", device=device)
    return Trainer(cfg, device=device)


def _loop_frames(trainer, max_images=None):
    """Each frame's (psnr, ssim) as the per-frame loop computes them."""
    out = []
    dm = trainer.eval_datamanager or trainer.datamanager
    for camera, batch in dm.eval_frames():
        rgb = trainer._render_rgb(camera)
        gt = batch["image"][..., :3]
        out.append((float(psnr(rgb, gt)), float(ssim(rgb, gt))))
        if max_images and len(out) >= max_images:
            break
    return np.array(out)


def _loop_report(trainer, monkeypatch, **kw):
    """`eval_all` down its per-frame loop (the path of a mixed-size split)."""
    with monkeypatch.context() as m:
        m.setattr(trainer, "_eval_arena", lambda dm, max_images: None)
        return trainer.eval_all(**kw)


def _sweep_table(trainer, max_images=None):
    dm = trainer.eval_datamanager or trainer.datamanager
    return trainer._eval_sweep(trainer._eval_arena(dm, max_images)).run()


# ----------------------------------------------------------------------------
# against the JAX package's sweep


def _jax_pair(scene, tmp_path, stage, monkeypatch):
    """A JAX trainer (stage 1 or its ControlTrainer) and the port's from the
    JAX trainer's initial state; the JAX LPIPS gate closed."""
    import jax

    from freegaussian_tpu.engine.control_trainer import ControlTrainer as JControlTrainer
    from freegaussian_tpu.engine.trainer import Trainer as JTrainer
    from freegaussian_tpu.engine.trainer import TrainerConfig as JTrainerConfig
    from freegaussian_tpu.models import metrics as j_metrics
    from freegaussian_tpu.models.densify import DensifyConfig as JDensifyConfig
    from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
    from freegaussian_tpu_torch.models.torch_compat import train_state_from_jax

    monkeypatch.setattr(j_metrics, "_lpips_fn", False)
    tcfg = _config(scene, tmp_path / "port", dict(MODEL, deform_impl="headsfused"))
    jcfg = JTrainerConfig(
        **{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(JTrainerConfig)
           if f.name not in ("splat", "densify", "optimizers")},
        splat=JConfig(backend="reference", **MODEL), densify=JDensifyConfig(refine_start=10**9),
    )
    jcfg = dataclasses.replace(jcfg, output_dir=str(tmp_path / "jax"))
    mask = scene / f"gaussian_mask_{LIVE}x2.npy"
    if stage == 2:
        jt, tt = JControlTrainer(jcfg, gaussian_mask_path=mask), ControlTrainer(tcfg, gaussian_mask_path=mask, device="cpu")
    else:
        jt, tt = JTrainer(jcfg), Trainer(tcfg, device="cpu")
    js = jt.state
    st = train_state_from_jax(
        jax.tree.map(np.asarray, js.params), np.asarray(js.alive), jax.tree.map(np.asarray, js.deform_vars),
        {g: jax.tree.map(np.asarray, s) for g, s in js.opt_states.items() if g in tt.state.opt_states},
        {k: np.asarray(getattr(js.densify, k)) for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
        step=0, generator=torch.Generator().manual_seed(0), cfg=tt.config.splat, device="cpu",
        control_vars_np=jax.tree.map(np.asarray, js.control_vars) if stage == 2 else None,
    )
    if stage == 2:
        st.deform.requires_grad_(False)
    tt.state = st
    tt._rebuild_step_fn()
    return jt, tt


@pytest.mark.parametrize("stage", [1, 2])
def test_sweep_matches_the_jax_sweep(scene, tmp_path, monkeypatch, stage):
    """(a), (b): the JAX `eval_all(max_images=3)` fast path and the port's
    sweep over the same three frames from the same state."""
    jt, tt = _jax_pair(scene, tmp_path, stage, monkeypatch)
    want = jt.eval_all(max_images=3)
    got = tt.eval_all(max_images=3)
    assert tt._eval_sweep_cache is not None, "the port took its loop"
    assert set(got) == set(want) == REPORT_KEYS
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-3)
    assert got["gaussian_count"] == want["gaussian_count"] == LIVE
    assert np.isnan(got["lpips"]) and got["lpips_available"] is want["lpips_available"] is False


# ----------------------------------------------------------------------------
# against the port's loop


@pytest.mark.parametrize("stage", [1, 2])
def test_sweep_equals_the_loop(scene, tmp_path, monkeypatch, stage):
    """(c): per frame bit-equal, the means within 1e-6 relative; on the CPU
    no graph is captured."""
    t = _trainer(scene, tmp_path, stage, dict(MODEL, deform_head_init_scale=1.0))
    got = t.eval_all()
    table = _sweep_table(t)
    np.testing.assert_array_equal(table, _loop_frames(t))
    want = _loop_report(t, monkeypatch)
    assert set(got) == set(want) == REPORT_KEYS
    for key in ("psnr", "ssim"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    assert got["gaussian_count"] == want["gaussian_count"] and got["fps"] > 0 and got["num_rays_per_sec"] > 0
    assert t.eval_graph_stats == {"captures": 0, "capture_s": 0.0, "replays": 0}


def _assert_rebuilt_and_fresh(t, before, stale):
    """The sweep is a new object and its frames are the loop's at the new
    state, which differ from the stale ones."""
    table = _sweep_table(t)
    assert t._eval_sweep_cache[1] is not before
    np.testing.assert_array_equal(table, _loop_frames(t))
    assert not np.array_equal(table, stale)


def test_cache_stage1_load_capacity_and_warm_up(scene, tmp_path):
    """(d), stage 1: `load()` of another checkpoint, the capacity tuner's new
    config, and crossing `warm_up` each give the new state's numbers."""
    # chunk 8: the binning pads its capacity to a multiple of it
    t = _trainer(scene, tmp_path, 1, dict(MODEL, warm_up=2, deform_head_init_scale=1.0, chunk=8))
    ckpt = t.save(0)
    with torch.no_grad():
        t.state.params["features_dc"].add_(0.3)
    stale = _sweep_table(t)
    sweep = t._eval_sweep_cache[1]
    np.testing.assert_array_equal(_sweep_table(t), stale)  # no change: the same sweep
    assert t._eval_sweep_cache[1] is sweep
    t.load(ckpt, 0)
    _assert_rebuilt_and_fresh(t, sweep, stale)

    # a binning capacity that overflows at this frame, then the tuner's doubling
    t.config = dataclasses.replace(t.config, splat=dataclasses.replace(t.config.splat, isect_capacity=32))
    t._rebuild_step_fn()
    stale, sweep = _sweep_table(t), t._eval_sweep_cache[1]
    np.testing.assert_array_equal(stale, _loop_frames(t))
    with pytest.warns(UserWarning, match="overflow"):
        t._maybe_grow_isect_capacity({"num_isects": 4096})
    assert t.config.splat.isect_capacity == 64
    _assert_rebuilt_and_fresh(t, sweep, stale)

    # the warm-up gate: before it the canonical Gaussians, after it deformed
    stale, sweep = _sweep_table(t), t._eval_sweep_cache[1]
    t.state.step = 2
    _assert_rebuilt_and_fresh(t, sweep, stale)


def test_cache_stage2_mask_and_init_time(scene, tmp_path):
    """(d), stage 2: a replaced cluster mask and a new init time."""
    t = _trainer(scene, tmp_path, 2, dict(MODEL, deform_head_init_scale=1.0))
    with torch.no_grad():  # a control field whose deltas show in the frame
        for p in t.state.control.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    stale, sweep = _sweep_table(t), t._eval_sweep_cache[1]
    t.gaussian_mask = ~t.gaussian_mask & t.state.alive[:, None]
    _assert_rebuilt_and_fresh(t, sweep, stale)
    stale, sweep = _sweep_table(t), t._eval_sweep_cache[1]
    t.init_time = 0.75
    _assert_rebuilt_and_fresh(t, sweep, stale)


class _MixedSplit:
    """An eval split whose second frame is half size."""

    def __init__(self, dm):
        self.dm = dm

    def __len__(self):
        return len(self.dm)

    def eval_frames(self):
        for i, (camera, batch) in enumerate(self.dm.eval_frames()):
            if i == 1:
                camera, batch = camera.downscaled(2), {"image": resize_image(batch["image"], 2)}
            yield camera, batch


def test_paths(scene, tmp_path, monkeypatch):
    """(e): a mixed-size split, `dump_dir` and available LPIPS take the loop;
    `max_images` is honoured by the sweep."""
    from torch_port_helpers import lpips_weights

    t = _trainer(scene, tmp_path, 1)
    two = t.eval_all(max_images=2)
    assert t._eval_sweep_cache[1].table.shape == (2, 2)
    np.testing.assert_allclose(two["psnr"], _loop_frames(t, 2)[:, 0].mean(), rtol=1e-6)
    t._eval_sweep_cache = None

    t.eval_datamanager = _MixedSplit(t.datamanager)
    mixed = t.eval_all()
    assert t._eval_sweep_cache is None and t._eval_arena(t.eval_datamanager, None) is None
    np.testing.assert_allclose(mixed["psnr"], _loop_frames(t)[:, 0].mean(), rtol=1e-6)
    t.eval_datamanager = None

    dumped = t.eval_all(max_images=3, dump_dir=tmp_path / "dump")
    assert t._eval_sweep_cache is None and set(dumped) == REPORT_KEYS
    pngs = sorted((tmp_path / "dump").glob("eval_*.png"))
    assert len(pngs) == 3 and read_png(pngs[0]).shape == (H, 2 * W, 3)

    weights = tmp_path / "lpips.npz"
    np.savez(weights, **lpips_weights(seed=2))
    monkeypatch.setenv("FREEGAUSSIAN_LPIPS_WEIGHTS", str(weights))
    scored = t.eval_all(max_images=3)
    assert t._eval_sweep_cache is None
    assert scored["lpips_available"] is True and np.isfinite(scored["lpips"])
    np.testing.assert_allclose(scored["psnr"], _loop_frames(t, 3)[:, 0].mean(), rtol=1e-6)


# ----------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep's graph is captured on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2])
def test_graphed_sweep_equals_the_eager_loop_on_the_card(cuda_device, tmp_path, stage):
    """(f): one graph a sweep, replayed once a frame after the warm-up
    frame, then F times a warm sweep; each frame within 1e-5 of the eager
    loop's; the launch counters count every frame's kernels; after `load()`
    the new state's numbers."""
    from freegaussian_tpu_torch.ops import mlp_cuda, rasterize_cuda

    root = write_scene(tmp_path / "scene")
    # the bf16 fields on their kernels: stage 1's deform field with its heads
    # (row 8), stage 2's control and deform trunks (row 6)
    model = dict(MODEL, deform_bf16=True, deform_head_init_scale=1.0, deform_impl="fused" if stage == 1 else "pallas")
    t = _trainer(root, tmp_path, stage, model, device=cuda_device)
    ckpt = t.save(0)
    counters = lambda: {**rasterize_cuda.LAUNCHES, **mlp_cuda.LAUNCHES}
    before = counters()
    t.eval_all()
    first = {k: v - before[k] for k, v in counters().items() if v != before[k]}
    table = _sweep_table(t)
    assert t.eval_graph_stats["captures"] == 1 and t.eval_graph_stats["replays"] == (FRAMES - 1) + FRAMES
    assert first == ({"rasterize_fwd": FRAMES, "deform_fwd": FRAMES} if stage == 1
                     else {"rasterize_fwd": FRAMES, "field_fwd": 3 * FRAMES})
    np.testing.assert_allclose(table, _loop_frames(t), rtol=0, atol=1e-5)
    with torch.no_grad():
        t.state.params["features_dc"].add_(0.3)
    stale = _sweep_table(t)
    t.load(ckpt, 0)
    table = _sweep_table(t)
    assert t.eval_graph_stats["captures"] == 2
    np.testing.assert_allclose(table, _loop_frames(t), rtol=0, atol=1e-5)
    assert not np.allclose(table, stale)
