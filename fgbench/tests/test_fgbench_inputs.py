"""The benchmark's inputs are a function of the seed alone."""

import numpy as np
import pytest
import torch

from helpers import FGBENCH  # noqa: F401


@pytest.mark.parametrize("seed", [0, 3_000_000_019])
def test_scene_and_frames_repeat_for_a_seed(seed):
    import scene

    dev = torch.device("cpu")
    a, b = scene.gaussians(500, seed, dev), scene.gaussians(500, seed, dev)
    assert all(torch.equal(a[k], b[k]) for k in a)
    other = scene.gaussians(500, seed + 1, dev)
    assert not torch.equal(a["means"], other["means"])
    assert all(torch.equal(x, y) for x, y in zip(scene.deform_weights(seed, dev).values(),
                                                 scene.deform_weights(seed, dev).values()))
    frames = scene.frames_of(6, 32, 24, 25.0)
    d1, f1, m1 = scene.frame_arrays(frames, seed, dev)
    d2, f2, m2 = scene.frame_arrays(frames, seed, dev)
    assert torch.equal(d1, d2) and torch.equal(f1, f2) and torch.equal(m1, m2)
    p1, p2 = scene.perturbed(a, seed), scene.perturbed(b, seed)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


def test_scene_matches_the_bench_operating_point():
    import scene

    g = scene.gaussians(20000, 7, torch.device("cpu"))
    op = torch.sigmoid(g["opacities"][:, 0])
    assert abs(float((op >= 0.55).float().mean()) - 0.5) < 0.02
    assert abs(float((op < 0.1).float().mean()) - 0.2) < 0.02
    assert torch.allclose(torch.linalg.vector_norm(g["quats"], dim=-1), torch.ones(20000), atol=1e-5)
    assert float(g["means"].std()) == pytest.approx(1.0, abs=0.02)


def test_ring_poses_survive_the_parsers_orientation():
    import scene

    poses = scene.ring_poses(36)
    assert np.abs(scene.oriented(poses) - poses[:, :3, :4].astype(np.float32)).max() < 1e-5
    i_train, i_eval = scene.split(36)
    assert len(i_train) == 33 and len(i_eval) == 3


def test_png_round_trips_through_the_programs_reader(tmp_path):
    import scene
    from freegaussian_tpu_torch.data.images import read_image

    rgb = np.random.default_rng(0).integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    (tmp_path / "a.png").write_bytes(scene.png_bytes(rgb))
    assert np.array_equal(read_image(tmp_path / "a.png"), rgb)
