"""The port's LPIPS (`models/metrics.py`) against the JAX package's, and its
local-weights gate.

No pretrained weights are fetched: both packages get the same seeded weights
(`torch_port_helpers.lpips_weights`) through the same npz file, the port by
`FREEGAUSSIAN_LPIPS_WEIGHTS` and the JAX package's network built from the
same arrays (`_build_lpips`, as tests/test_lpips_torch.py builds it). The
two forwards agree within rtol 1e-5. Without a file the port's `lpips()`
returns None and `Trainer.eval_all` reports NaN with lpips_available False;
with one it reports the mean over the eval frames.
"""

import warnings

import numpy as np
import pytest
import torch

from freegaussian_tpu.models import metrics as j_metrics
from freegaussian_tpu_torch.models import metrics
from torch_port_helpers import lpips_weights


@pytest.fixture()
def weights_file(tmp_path, monkeypatch):
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **lpips_weights(seed=3))
    monkeypatch.setenv("FREEGAUSSIAN_LPIPS_WEIGHTS", str(path))
    return path


def _pair(seed, h, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), -0.2, 1.2).astype(np.float32)  # lpips clips to [0, 1]
    return a, b


@pytest.mark.parametrize("seed,h,w", [(0, 64, 64), (1, 48, 80), (2, 100, 72)])
def test_lpips_matches_jax(weights_file, seed, h, w):
    a, b = _pair(seed, h, w)
    got = metrics.lpips(torch.tensor(a), torch.tensor(b))
    jax_fn = j_metrics._build_lpips(dict(np.load(weights_file)))
    to_nchw = lambda im: np.transpose(np.clip(im, 0, 1) * 2 - 1, (2, 0, 1))[None].astype(np.float32)
    want = float(jax_fn(to_nchw(a), to_nchw(b)))
    assert got is not None and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert metrics.lpips(torch.tensor(a), torch.tensor(a)) == pytest.approx(0.0, abs=1e-6)


def test_lpips_gate_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("FREEGAUSSIAN_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    a, b = _pair(0, 32, 32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert metrics.lpips(torch.tensor(a), torch.tensor(b)) is None


def test_lpips_weights_path_default(monkeypatch):
    monkeypatch.delenv("FREEGAUSSIAN_LPIPS_WEIGHTS", raising=False)
    assert metrics.default_weights_path() == j_metrics.default_weights_path()
    assert str(metrics.default_weights_path()).endswith(".cache/freegaussian/lpips_alex.npz")


def test_eval_all_reports_lpips_by_the_gate(tmp_path, monkeypatch):
    from freegaussian_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from test_data import make_synthetic_dataset

    make_synthetic_dataset(tmp_path / "data", n=4, h=32, w=48)
    cfg = TrainerConfig(data=str(tmp_path / "data"), capacity=64, num_random=30, output_dir=str(tmp_path / "out"))
    trainer = Trainer(cfg, device="cpu")
    monkeypatch.setenv("FREEGAUSSIAN_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        none = trainer.eval_all()
    assert np.isnan(none["lpips"]) and none["lpips_available"] is False
    path = tmp_path / "w.npz"
    np.savez(path, **lpips_weights(seed=4))
    monkeypatch.setenv("FREEGAUSSIAN_LPIPS_WEIGHTS", str(path))
    some = trainer.eval_all()
    frames = [(trainer._render_rgb(cam), batch["image"][..., :3]) for cam, batch in trainer.datamanager.eval_frames()]
    want = np.mean([metrics.lpips(a, b) for a, b in frames])
    assert some["lpips_available"] is True and some["lpips"] == pytest.approx(want, rel=1e-6)
    assert set(some) == {"psnr", "ssim", "num_rays_per_sec", "fps", "gaussian_count", "lpips", "lpips_available"}
