"""The port's whole two-stage pipeline through its CLI on the CPU, with no
JAX call in the port: train -> cluster -> train-control (on that mask) ->
eval (stage 1 and stage 2) -> render (dataset and orbit) -> export (ply and
torch), on a tiny dataset (tests/test_data.py), each verb in process through
`cli.main` with `--device cpu`.

The cluster verb's mask is held against the JAX package's
`cluster_gaussians` on the same state: the port's `export --format torch`
file loaded by the JAX package's `load_reference_checkpoint`, the same
frames' cameras and masks, the JAX dense oracle (`backend="reference"`);
rows on a vote boundary are counted and left out as in
tests/test_torch_cluster.py (`vote_boundary_rows`), every other row is
equal. Eval reports carry the JAX package's keys; LPIPS is NaN without
weights and, with seeded weights (not a quality number), the mean of the
frames' LPIPS.
"""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models import torch_compat as j_compat
from freegaussian_tpu.preprocess.clustering import cluster_gaussians as j_cluster_gaussians
from freegaussian_tpu_torch import cli
from freegaussian_tpu_torch.data.splat_export import import_splat_ply
from freegaussian_tpu_torch.models.gaussians import PARAM_NAMES
from freegaussian_tpu_torch.models.metrics import lpips
from freegaussian_tpu_torch.models.torch_compat import load_reference_checkpoint
from freegaussian_tpu_torch.viewer.png import read_png
from test_data import make_synthetic_dataset
from torch_port_helpers import jax_camera, lpips_weights, vote_boundary_rows

REPO = Path(__file__).resolve().parents[1]
BASE, CONTROL_BASE = str(REPO / "configs/sim/base.yaml"), str(REPO / "configs/control/sim/base.yaml")
FRAMES, H, W = 6, 32, 48


def _run(argv):
    """cli.main in process; returns (its return value, the last stdout line)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = cli.main([str(a) for a in argv])
    return out, buf.getvalue().strip().splitlines()[-1]


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """Two `train` steps from 2048 random Gaussians (capacity 4096)."""
    root = tmp_path_factory.mktemp("pipeline")
    data = root / "scene"
    make_synthetic_dataset(data, n=FRAMES, h=H, w=W)
    over = root / "over.yaml"
    over.write_text(
        f"max_num_iterations: 2\ncapacity: 4096\nnum_random: 3000\nsteps_per_log: 1\nsteps_per_save: 0\n"
        f"steps_per_eval_image: 0\nsteps_per_eval_all_images: 0\noutput_dir: {root / 'out'}\nvis: jsonl\n"
        "pipeline:\n  model:\n    warm_up: 0\n    num_downscales: 0\n"
    )
    trainer, last = _run(["train", "--data", data, "--config", BASE, "--scene-config", over, "--device", "cpu"])
    assert np.isfinite(json.loads(last)["loss"])
    flags = ["--data", data, "--config", BASE, "--scene-config", over, "--load", root / "out/freegaussian/checkpoints",
             "--device", "cpu"]
    return dict(root=root, data=data, over=over, flags=flags, trainer=trainer,
                ckpt=root / "out/freegaussian/checkpoints")


@pytest.fixture(scope="module")
def clustered(stage1):
    """The `cluster` verb with its defaults: the mask in the dataset directory."""
    trainer, last = _run(["cluster", *stage1["flags"]])
    n_live = int(trainer.state.alive.sum())
    mask_path = stage1["data"] / f"gaussian_mask_{n_live}x2.npy"
    assert last == f"wrote {mask_path} and cluster PLY"
    return dict(trainer=trainer, mask=mask_path)


def _jax_cluster(stage1, trainer, tmp_path, **kw):
    """The JAX package's vote on the port's state (its torch export loaded by
    the JAX package) over the trainer's frames; returns (mask, rows on a
    boundary), both over the live rows."""
    _run(["export", *stage1["flags"], "--format", "torch", "--out", tmp_path / "state.ckpt"])
    loaded = j_compat.load_reference_checkpoint(tmp_path / "state.ckpt")
    params, alive = loaded["params"], loaded["alive"]
    frames = trainer.datamanager.frames
    arrs = {
        i: dict(c2w=f.camera.c2w.numpy(), fx=f.camera.fx.numpy(), fy=f.camera.fy.numpy(), cx=f.camera.cx.numpy(),
                cy=f.camera.cy.numpy(), time=f.camera.time.numpy(), width=f.camera.width, height=f.camera.height)
        for i, f in enumerate(frames)
    }
    valids = {i: trainer.parsed.mask_valids[i] for i in arrs}
    mask = j_cluster_gaussians(
        params, alive, {i: jnp.asarray(f.atrb_mask) for i, f in enumerate(frames)},
        {i: jax_camera(a) for i, a in arrs.items()}, mask_valids=valids, backend="reference", **kw,
    )
    np_params = {k: np.asarray(v) for k, v in params.items()}
    low, high = kw.get("depth_low", -0.1), kw.get("depth_high", 1.0)
    excluded = np.zeros(len(np.asarray(alive)), bool)
    for a in arrs.values():
        excluded |= vote_boundary_rows(np_params, np.asarray(alive), a, low=low, high=high)
    return np.asarray(mask)[np.asarray(alive)], excluded[np.asarray(alive)]


@pytest.mark.parametrize("variant", ["defaults", "exclusive_window"])
def test_cluster_verb_matches_jax(stage1, clustered, tmp_path, variant):
    if variant == "defaults":
        mask_path, kw = clustered["mask"], {}
    else:
        mask_path = tmp_path / "mask.npy"
        _run(["cluster", *stage1["flags"], "--exclusive", "--depth-window", "-0.5", "1.0", "--out", mask_path])
        kw = dict(exclusive=True, depth_low=-0.5, depth_high=1.0)
    got = np.load(mask_path)
    n_live = int(stage1["trainer"].state.alive.sum())
    assert got.shape == (n_live, 2) and got.dtype == bool
    assert mask_path.with_suffix(".ply").read_bytes().startswith(b"ply\n")
    want, excluded = _jax_cluster(stage1, clustered["trainer"], tmp_path, **kw)
    assert excluded.sum() <= 0.03 * n_live
    np.testing.assert_array_equal(got[~excluded], want[~excluded])


def test_cluster_verb_key_frames_and_dynamic(stage1, tmp_path):
    """`--key-frames --scene` votes over the listed frames only; `--dynamic`
    runs the deform field at each frame's time."""
    kf = tmp_path / "key_frames.yaml"
    kf.write_text("tiny: {frames: [0, 2, 4]}\n")
    from freegaussian_tpu_torch.preprocess import clustering

    trainer, _ = _run(["cluster", *stage1["flags"], "--key-frames", kf, "--scene", "tiny", "--dynamic",
                       "--depth-window", "-0.5", "1.0", "--out", tmp_path / "dyn.npy"])
    masks, cameras, valids = cli.cluster_inputs(trainer, str(kf), "tiny")
    assert sorted(masks) == [0, 2, 4] and sorted(valids) == [0, 2, 4]
    st = trainer.state
    want = clustering.cluster_gaussians(st.params, st.alive, masks, cameras, deform=st.deform, mask_valids=valids,
                                        depth_low=-0.5, depth_high=1.0)
    np.testing.assert_array_equal(np.load(tmp_path / "dyn.npy"), want[st.alive].numpy())


def test_train_control_on_the_cluster_mask_and_stage2_eval(stage1, clustered, tmp_path, monkeypatch):
    over2 = tmp_path / "over2.yaml"
    over2.write_text(stage1["over"].read_text().replace("max_num_iterations: 2", "max_num_iterations: 1").replace(
        str(stage1["root"] / "out"), str(tmp_path / "out2")))
    flags2 = ["--data", stage1["data"], "--config", CONTROL_BASE, "--scene-config", over2, "--stage1-checkpoint",
              stage1["ckpt"], "--gaussian-mask", clustered["mask"], "--device", "cpu"]
    ctrainer, last = _run(["train-control", *flags2])
    assert np.isfinite(json.loads(last)["loss"])
    np.testing.assert_array_equal(ctrainer.gaussian_mask[ctrainer.state.alive].numpy(), np.load(clustered["mask"]))

    weights = tmp_path / "lpips.npz"
    np.savez(weights, **lpips_weights(seed=1))
    monkeypatch.setenv("FREEGAUSSIAN_LPIPS_WEIGHTS", str(weights))
    trainer, last = _run(["eval", *flags2, "--load", tmp_path / "out2/freegaussian/checkpoints",
                          "--dump-images", tmp_path / "dump", "--report", tmp_path / "report.json"])
    result = json.loads(last)
    assert json.loads((tmp_path / "report.json").read_text()) == result
    assert type(trainer).__name__ == "ControlTrainer" and int(trainer.state.step) == 1
    frames = [(trainer._render_rgb(cam), b["image"][..., :3]) for cam, b in trainer.datamanager.eval_frames()]
    assert result["lpips_available"] is True
    assert result["lpips"] == pytest.approx(np.mean([lpips(a, b) for a, b in frames]), rel=1e-6)
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"]) and result["fps"] > 0
    dumps = sorted((tmp_path / "dump").glob("eval_*.png"))
    assert len(dumps) == FRAMES and read_png(dumps[0]).shape == (H, 2 * W, 3)


def test_eval_verb_stage1(stage1, tmp_path, monkeypatch):
    monkeypatch.setenv("FREEGAUSSIAN_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    trainer, last = _run(["eval", *stage1["flags"], "--dump-images", tmp_path / "dump", "--report",
                          tmp_path / "r/report.json"])
    result = json.loads(last)
    assert set(result) == {"psnr", "ssim", "num_rays_per_sec", "fps", "gaussian_count", "lpips", "lpips_available"}
    assert json.loads((tmp_path / "r/report.json").read_text())["psnr"] == result["psnr"]
    assert np.isnan(result["lpips"]) and result["lpips_available"] is False
    assert int(trainer.state.step) == 2 and result["gaussian_count"] == int(trainer.state.alive.sum())
    assert len(list((tmp_path / "dump").glob("eval_*.png"))) == FRAMES


@pytest.mark.parametrize("path", ["dataset", "orbit"])
def test_render_verb(stage1, tmp_path, path):
    extra = ["--path", "orbit", "--num-frames", "4"] if path == "orbit" else []
    _, last = _run(["render", *stage1["flags"], "--out", tmp_path / "r", *extra])
    n = 4 if path == "orbit" else FRAMES
    assert last == f"rendered {n} views to {tmp_path / 'r'}"
    pngs, npys = sorted((tmp_path / "r/rgb").glob("*.png")), sorted((tmp_path / "r/depth").glob("*.npy"))
    assert len(pngs) == len(npys) == n
    assert read_png(pngs[0]).shape == (H, W, 3)
    depth = np.load(npys[-1])
    assert depth.shape == (H, W) and np.isfinite(depth).all()


def test_export_verb(stage1, tmp_path):
    trainer, last = _run(["export", *stage1["flags"], "--out", tmp_path / "s.ply"])
    st = trainer.state
    n = int(st.alive.sum())
    assert last == f"wrote {n} gaussians to {tmp_path / 's.ply'}"
    params, count = import_splat_ply(tmp_path / "s.ply")
    assert count == n
    for name in PARAM_NAMES:
        assert torch.equal(params[name], st.params[name].detach()[st.alive]), name

    _, last = _run(["export", *stage1["flags"], "--format", "torch", "--out", tmp_path / "s.ckpt"])
    assert last == f"wrote reference checkpoint to {tmp_path / 's.ckpt'}"
    model = load_reference_checkpoint(tmp_path / "s.ckpt", cfg=trainer.config.splat, device="cpu")
    assert model.step == int(st.step) == 2
    cam = trainer.datamanager.frames[1].camera
    np.testing.assert_allclose(model(cam)["rgb"].numpy(), trainer._render_rgb(cam).numpy(), atol=1e-6)
    loaded = j_compat.load_reference_checkpoint(tmp_path / "s.ckpt")
    np.testing.assert_array_equal(np.asarray(loaded["params"]["means"]), st.params["means"].detach()[st.alive].numpy())
