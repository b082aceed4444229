"""The port's interflow (`preprocess/epipolar_flow.py` and the `interflow`
verb) against the JAX package's on seeded cameras, depths (with infinite,
zero and negative pixels) and optical flow: the pixel Jacobians, both forms
(velocity and backprojection), and the files `generate_interflow_dataset`
writes for the synthetic and real layouts. Budget: 1e-4 px relative to the
largest flow (both sides f32; the JAX package's products on the CPU),
masked pixels exactly 0."""

import io
import shutil
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.preprocess import epipolar_flow as j_flow
from freegaussian_tpu_torch import cli
from freegaussian_tpu_torch.preprocess import epipolar_flow as t_flow
from test_data import make_synthetic_dataset
from torch_port_helpers import jax_camera, look_at_c2w, make_real_capture, torch_camera

RTOL = 1e-4  # of the largest |flow|


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= RTOL * scale, float(np.abs(got - want).max()) / scale


def _cams(h=20, w=28):
    base = dict(fx=np.float32(25.0), fy=np.float32(26.5), cx=np.float32(w / 2 + 0.8), cy=np.float32(h / 2 - 0.6),
                width=w, height=h)
    a0 = dict(base, c2w=look_at_c2w((0.6, 0.4, 3.0)), time=np.float32(0.2))
    a1 = dict(base, c2w=look_at_c2w((0.9, 0.35, 2.9), target=(0.05, 0.0, 0.0)), time=np.float32(0.4))
    return a0, a1


@pytest.mark.parametrize("form", ["diff_2d_epipolar_flow", "diff_2d_epipolar_flow_backproject"])
def test_forms_match_jax(form):
    a0, a1 = _cams()
    rng = np.random.default_rng(1)
    Z = rng.uniform(1.0, 6.0, size=(20, 28, 1)).astype(np.float32)
    Z[0, :3, 0] = [np.inf, 0.0, -2.0]
    of = rng.normal(size=(20, 28, 2)).astype(np.float32)
    want = getattr(j_flow, form)(jnp.asarray(Z), jax_camera(a0), jax_camera(a1), jnp.asarray(of))
    got = getattr(t_flow, form)(torch.from_numpy(Z), torch_camera(a0), torch_camera(a1), torch.from_numpy(of))
    for k in ("sceneflow", "interflow"):
        _close(got[k].numpy(), want[k])
        assert not got[k][0, :3].any()
    for a, b in zip(t_flow.pixel_jacobians(torch_camera(a0)), j_flow.pixel_jacobians(jax_camera(a0))):
        _close(a.numpy(), b)


@pytest.mark.parametrize("layout,form", [("synthetic", "velocity"), ("real", "backproject")])
def test_generate_interflow_dataset_matches_jax(tmp_path, layout, form):
    """The same files, names and directories (interflow_n{k}/ or
    flow_n{k}/), each map within the budget; a frame without optical flow
    gets zero flow, a missing depth render raises as in the JAX package."""
    if layout == "synthetic":
        make_synthetic_dataset(tmp_path / "a", n=5, h=20, w=28)
        shutil.copytree(tmp_path / "a", tmp_path / "b")
        rng = np.random.default_rng(2)
        for d in ("a", "b"):
            (tmp_path / d / "opticalflow").mkdir()
        for i in range(4):
            f = rng.normal(size=(20, 28, 2)).astype(np.float32)
            for d in ("a", "b"):
                np.save(tmp_path / d / "opticalflow" / f"frame_{i:04d}.npy", f)
        out = "interflow_n2"
    else:
        make_real_capture(tmp_path / "a", n=5, h=20, w=28, num_attributes=0, fg_masks=False, points=None)
        shutil.copytree(tmp_path / "a", tmp_path / "b")
        out = "flow_n2"
    kw = dict(interval=2, form=form, dataparser=layout)
    assert t_flow.generate_interflow_dataset(tmp_path / "a", device="cpu", **kw) == 5
    assert j_flow.generate_interflow_dataset(tmp_path / "b", **kw) == 5
    names = sorted(p.name for p in (tmp_path / "b" / out).iterdir())
    assert sorted(p.name for p in (tmp_path / "a" / out).iterdir()) == names and len(names) == 5
    for name in names:
        got, want = np.load(tmp_path / "a" / out / name), np.load(tmp_path / "b" / out / name)
        _close(got, want)
    victim = next((tmp_path / "a" / "depth").iterdir())
    victim.unlink()
    with pytest.raises(FileNotFoundError, match="missing depth render"):
        t_flow.generate_interflow_dataset(tmp_path / "a", device="cpu", **kw)


def test_interflow_verb(tmp_path):
    """`interflow` through cli.main: JAX's flags, its output line, the maps
    in flow_n{k}/ for a real capture; --device cuda without a card exits
    non-zero."""
    make_real_capture(tmp_path, n=4, h=16, w=20, num_attributes=0, fg_masks=False, points=None)
    buf = io.StringIO()
    with redirect_stdout(buf):
        n = cli.main(["interflow", "--data", str(tmp_path), "--interval", "1", "--form", "backproject",
                      "--dataparser", "real", "--flow-dir", "opticalflow", "--device", "cpu"])
    assert n == 4 and buf.getvalue().strip().splitlines()[-1] == "wrote 4 interflow maps"
    assert len(list((tmp_path / "flow_n1").glob("*.npy"))) == 4
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="interflow"):
            cli.main(["interflow", "--data", str(tmp_path), "--dataparser", "real"])
