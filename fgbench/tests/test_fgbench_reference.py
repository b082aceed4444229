"""The reference agrees with itself at a tiny size: the tiled compositor
against a dense walk of every Gaussian in depth order, at two tile sizes;
SSIM of an image with itself; the field in f32 against bf16."""

import pytest
import torch

from helpers import FGBENCH  # noqa: F401


def dense(means2d, conics, colors, opac, depths, width, height):
    from reference import core

    order = torch.argsort(depths, stable=True)
    ys, xs = torch.meshgrid(torch.arange(height).float() + 0.5, torch.arange(width).float() + 0.5, indexing="ij")
    px, py = xs.reshape(-1, 1), ys.reshape(-1, 1)
    m, con, op, col = means2d[order], conics[order], opac[order], colors[order]
    dx, dy = m[None, :, 0] - px, m[None, :, 1] - py
    sigma = 0.5 * (con[None, :, 0] * dx * dx + con[None, :, 2] * dy * dy) + con[None, :, 1] * dx * dy
    alpha = torch.clamp(op[None] * torch.exp(-sigma), max=core.MAX_ALPHA)
    vis = (sigma >= 0) & (alpha >= core.ALPHA_THRESHOLD)
    a = torch.where(vis, alpha, torch.zeros_like(alpha))
    excl = torch.cumprod(torch.cat([torch.ones_like(a[:, :1]), 1 - a[:, :-1]], 1), 1)
    done = torch.cummax(((excl * (1 - a)) <= core.TRANSMITTANCE_EPS).int(), 1).values > 0
    w = torch.where(vis & ~done, a * excl, torch.zeros_like(a))
    return (w @ col).reshape(height, width, -1), w.sum(1).reshape(height, width, 1)


def case(n=300, width=40, height=24, seed=0):
    from reference import core

    g = torch.Generator().manual_seed(seed)
    means = torch.randn((n, 3), generator=g) * 0.6
    quats = torch.randn((n, 4), generator=g)
    scales = torch.full((n, 3), 0.05) * (1 + torch.rand((n, 3), generator=g))
    opac = 0.05 + 0.9 * torch.rand(n, generator=g)
    colors = torch.rand((n, 4), generator=g)
    c2w = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]])
    vm = core.viewmat(c2w)
    K = core.intrinsics(30.0, 30.0, width / 2, height / 2, "cpu")
    m2d, depths, conics, radii = core.project(means, quats, scales, vm, K, width, height)
    return m2d, conics, colors, opac, depths, core.tight_radii(radii, opac), radii


@pytest.mark.parametrize("tile", [8, 16])
def test_tiled_compositor_matches_the_dense_walk(tile):
    from reference import core

    m2d, conics, colors, opac, depths, rad, radii = case()
    vis = radii > 0
    want, want_a = dense(m2d[vis], conics[vis], colors[vis], opac[vis], depths[vis], 40, 24)
    got, got_a = core.composite(m2d, conics, colors, opac, depths, rad, 40, 24, tile=tile, tiles_per_chunk=3)
    assert float(want_a.max()) > 0.5
    assert torch.allclose(got, want, atol=1e-5) and torch.allclose(got_a, want_a, atol=1e-5)


def test_compositor_gradients_do_not_depend_on_the_tile():
    from reference import core

    grads = []
    for tile in (8, 16):
        m2d, conics, colors, opac, depths, rad, _ = case(seed=1)
        leaves = [t.requires_grad_(True) for t in (m2d, conics, colors, opac)]
        r, a = core.composite(*leaves, depths, rad, 40, 24, tile=tile)
        grads.append(torch.autograd.grad((r.sum() + a.sum()), leaves))
    for x, y in zip(*grads):
        assert torch.allclose(x, y, atol=1e-5, rtol=1e-4)


def test_ssim_of_an_image_with_itself_is_one():
    from reference import core

    img = torch.rand((20, 30, 3), generator=torch.Generator().manual_seed(0))
    assert float(core.ssim(img, img)) == pytest.approx(1.0, abs=1e-6)
    assert float(core.ssim(img, 1 - img)) < 0.5


def test_field_trunk_in_bf16_follows_a_float64_trunk():
    import torch.nn.functional as F

    import scene
    from reference import core

    w = scene.deform_weights(3, torch.device("cpu"))
    emb = core.bf16_values(torch.randn((256, 93), generator=torch.Generator().manual_seed(0)))
    got = core.trunk(emb, w)
    h = None
    e = emb.double()
    for i in range(8):
        inp = e if i == 0 else (torch.cat([e, h], -1) if i == 5 else h)
        h = F.relu(inp @ w[f"linear.{i}.weight"].double().T + w[f"linear.{i}.bias"].double())
    assert float((got.double() - h).norm() / h.norm()) < 2e-2
    assert torch.equal(got, core.bf16_values(got))
