"""The CUDA tile compositor against its plain PyTorch version, on a GPU.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and skips
without a card. The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance: atol 2e-5 on color, alpha and t_final (the kernel sums a pixel's
colors in walk order, the plain version as one contraction: f32 summation
order only); livecnt is exact, since both round every product and sum of
the termination test alike.
"""

import numpy as np
import pytest
import torch

from freegaussian_tpu_torch.ops import rasterize_cuda
from freegaussian_tpu_torch.ops.rasterize_cuda import rasterize_tiles, rasterize_tiles_plain
from freegaussian_tpu_torch.ops.tiles import build_intersections
from torch_port_helpers import clustered_scene_2d

ATOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(device, n, width, height, channels, seed, tile_size, dense=True):
    scene = clustered_scene_2d(n=n, width=width, height=height, seed=seed, channels=channels, dense=dense)
    m, con, col, op, dep, rad = [torch.tensor(a, device=device) for a in scene]
    r = rad.float()
    isect = build_intersections(m, r, dep, width, height, tile_size)
    return (m, con, col, op, r, isect.gauss_ids, isect.tile_offsets, width, height, tile_size)


def _assert_matches(got, want):
    for name, a, b in zip(("color", "alpha", "livecnt", "t_final"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "livecnt":
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("channels", [3, 4, 6, 8])
def test_cuda_kernel_matches_plain(cuda_device, channels, tile_size):
    # 100 x 70 is not a multiple of either tile size: ragged edge tiles
    args = _inputs(cuda_device, 600, 100, 70, channels, channels, tile_size)
    before = rasterize_cuda.LAUNCHES["rasterize_fwd"]
    got = rasterize_tiles(*args)
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES["rasterize_fwd"] == before + 1
    _assert_matches(got, rasterize_tiles_plain(*args))
    assert (got[3] < 0.01).any()  # some pixels terminate


@pytest.mark.cuda
def test_cuda_kernel_writes_empty_frame(cuda_device):
    m, con, col, op, r, ids, offs, w, h, ts = _inputs(cuda_device, 40, 64, 48, 3, 1, 32, dense=False)
    r = torch.zeros_like(r)
    isect = build_intersections(m, r, torch.ones_like(r), w, h, ts)
    assert isect.num_isects == 0
    color, alpha, livecnt, t_final = rasterize_tiles(m, con, col, op, r, isect.gauss_ids, isect.tile_offsets, w, h, ts)
    torch.cuda.synchronize()
    assert torch.all(color == 0) and torch.all(alpha == 0)
    assert torch.all(livecnt == 0) and torch.all(t_final == 1)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_mixed_devices(cuda_device):
    args = list(_inputs(cuda_device, 50, 32, 32, 3, 2, 16))
    args[5] = args[5].cpu()
    with pytest.raises(ValueError, match="gauss_ids"):
        rasterize_tiles(*args)


@pytest.mark.cuda
def test_rasterization_on_cuda_launches_the_kernel(cuda_device):
    from freegaussian_tpu_torch.ops.rasterize import rasterization
    from torch_port_helpers import camera_arrays, gaussian_scene_3d, torch_camera

    params, alive = gaussian_scene_3d(n=300, seed=3)
    cam = torch_camera(camera_arrays(width=96, height=64), device=cuda_device)
    t = lambda a: torch.tensor(np.asarray(a), device=cuda_device)
    k = params["features_rest"].shape[1] // 3 + 1
    sh = np.concatenate([params["features_dc"][:, None], params["features_rest"].reshape(-1, k - 1, 3)], axis=1)
    args = (
        t(params["means"]), t(params["quats"]), t(np.exp(params["scales"])),
        t(1.0 / (1.0 + np.exp(-params["opacities"][:, 0]))), t(sh),
        cam.viewmat[None], cam.K[None], 96, 64,
    )
    before = rasterize_cuda.LAUNCHES["rasterize_fwd"]
    render, alpha, _ = rasterization(*args, render_mode="RGB+ED", sh_degree=3, tile_size=32, alive=t(alive))
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES["rasterize_fwd"] == before + 1
    cpu = rasterization(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args],
                        render_mode="RGB+ED", sh_degree=3, tile_size=32, alive=t(alive).cpu())
    assert torch.isfinite(render).all()
    # the same projection on another device: f32 rounding, then the compositing budget
    torch.testing.assert_close(alpha.cpu(), cpu[1], atol=1e-4, rtol=0)
    torch.testing.assert_close(render[..., :3].cpu(), cpu[0][..., :3], atol=1e-4, rtol=0)
