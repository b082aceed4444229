"""The reference compositor recomputes each chunk's (T, P, K) block in the
backward. Against the form that kept every chunk's block for the backward
(a frozen copy below): the render, alpha and walked pairs are bit-equal, so
are every leaf's gradient of a tiny stage-1 and stage-2 step, and the bytes
autograd keeps no longer grow with a tile's pixels."""

import pytest
import torch

from helpers import tiny_cell
from test_fgbench_reference import case


def former_composite(means2d, conics, colors, opac, depths, radii_px, width: int, height: int, *, tile: int = 16,
                     tiles_per_chunk: int = 32, count_walk: bool = False):
    """`reference/core.py:composite` as it was before the recompute: every
    chunk's (T, P, K) block kept by autograd until the backward."""
    from reference.core import ALPHA_THRESHOLD, MAX_ALPHA, TRANSMITTANCE_EPS, _bin

    dev = means2d.device
    tw, th = -(-width // tile), -(-height // tile)
    with torch.no_grad():
        gids, counts = _bin(means2d.detach(), depths.detach(), radii_px, tile, tw, th)
        offsets = torch.cumsum(counts, 0) - counts
        counts_h, offsets_h = counts.tolist(), offsets.tolist()
    P = tile * tile
    py_in, px_in = torch.meshgrid(torch.arange(tile, device=dev), torch.arange(tile, device=dev), indexing="ij")
    px_in, py_in = px_in.reshape(-1).float(), py_in.reshape(-1).float()
    C = colors.shape[-1]
    renders, alphas, walked = [], [], 0
    for c0 in range(0, tw * th, tiles_per_chunk):
        tiles = list(range(c0, min(c0 + tiles_per_chunk, tw * th)))
        K = max(counts_h[t] for t in tiles)
        T = len(tiles)
        if K == 0:
            renders.append(torch.zeros((T, P, C), device=dev, dtype=colors.dtype))
            alphas.append(torch.zeros((T, P), device=dev, dtype=colors.dtype))
            continue
        with torch.no_grad():
            kk = torch.arange(K, device=dev)
            cnt = torch.tensor([counts_h[t] for t in tiles], device=dev)
            off = torch.tensor([offsets_h[t] for t in tiles], device=dev)
            valid = kk[None, :] < cnt[:, None]
            idx = torch.where(valid, gids[torch.clamp(off[:, None] + kk[None, :], max=max(gids.shape[0] - 1, 0))], 0)
            tt = torch.tensor(tiles, device=dev)
            ox, oy = (tt % tw).float() * tile, (tt // tw).float() * tile
            px = ox[:, None] + px_in[None, :] + 0.5  # (T, P)
            py = oy[:, None] + py_in[None, :] + 0.5
        m, con, op, col = means2d[idx], conics[idx], opac[idx], colors[idx]  # (T, K, ...)
        dx = m[:, None, :, 0] - px[:, :, None]  # (T, P, K)
        dy = m[:, None, :, 1] - py[:, :, None]
        sigma = 0.5 * (con[:, None, :, 0] * dx * dx + con[:, None, :, 2] * dy * dy) + con[:, None, :, 1] * dx * dy
        alpha = torch.clamp(op[:, None, :] * torch.exp(-sigma), max=MAX_ALPHA)
        vis = valid[:, None, :] & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD)
        a_eff = torch.where(vis, alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - a_eff
        excl = torch.cumprod(torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], -1), -1)
        incl = excl * one_minus
        done = torch.cummax((incl <= TRANSMITTANCE_EPS).to(torch.int32), dim=-1).values > 0
        w = torch.where(vis & ~done, a_eff * excl, torch.zeros_like(a_eff))
        renders.append(torch.einsum("tpk,tkc->tpc", w, col))
        alphas.append(w.sum(-1))
        if count_walk:
            with torch.no_grad():
                live = valid[:, None, :] & ~done
                walked += int(live.sum()) + int(done[..., -1].sum())
    r = torch.cat(renders).reshape(th, tw, tile, tile, C).permute(0, 2, 1, 3, 4).reshape(th * tile, tw * tile, C)
    a = torch.cat(alphas).reshape(th, tw, tile, tile).permute(0, 2, 1, 3).reshape(th * tile, tw * tile)
    res = (r[:height, :width], a[:height, :width, None])
    return res + (walked,) if count_walk else res


def _equal(x, y):
    return all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b for a, b in zip(x, y))


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("tile", [8, 16])
def test_render_alpha_and_walk_are_the_former_form_s(tile, grad):
    from reference import core

    m2d, conics, colors, opac, depths, rad, _ = case(n=500, seed=2)
    with torch.set_grad_enabled(grad):
        leaves = [t.requires_grad_(grad) for t in (m2d, conics, colors, opac)]
        got = core.composite(*leaves, depths, rad, 40, 24, tile=tile, tiles_per_chunk=3, count_walk=True)
        want = former_composite(*leaves, depths, rad, 40, 24, tile=tile, tiles_per_chunk=3, count_walk=True)
    assert float(want[1].detach().max()) > 0.5 and want[2] > 0
    assert _equal(got, want)
    assert got[0].requires_grad == grad


def _step_grads(name, monkeypatch, composite):
    import train
    from reference import core, stage1

    monkeypatch.setattr(core, "composite", composite)
    _, cfg, traffic = tiny_cell(name)
    dev = torch.device("cpu")
    inputs = train.Inputs(cfg, 11, dev)
    step = train.reference_step(cfg, traffic, inputs)
    frame = inputs.frames[int(inputs.i_train[1])]
    batch = stage1.batch_of(frame, inputs.images8, inputs.depth, inputs.flow)
    return step.grads(frame, batch, torch.tensor([0.3, 0.6, 0.9]), count_walk=True)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["s1_train_chunk10", "s2_train_chunk10"])
def test_step_gradients_are_the_former_form_s(name, monkeypatch, one_thread):
    """Bit-equal on one CPU thread: the recompute runs the same ops on the
    same inputs, and autograd takes the chunks' backwards in the same order.
    (On several threads the CPU splits its reductions by thread, and the
    former form differs from itself in the last bits run to run.)"""
    from reference import core

    parts, grads = _step_grads(name, monkeypatch, core.composite)
    want_parts, want_grads = _step_grads(name, monkeypatch, former_composite)
    assert parts == want_parts
    assert sorted(grads) == sorted(want_grads)
    for k in grads:
        assert torch.equal(grads[k], want_grads[k]), k
    assert any(float(g.abs().max()) > 0 for g in grads.values())


def _one_tile(tile: int, n: int = 64):
    """`n` wide Gaussians over a frame of one tile, so every tile size holds
    one tile (T 1) of the same `n` pairs (K n) and only its pixels P grow."""
    g = torch.Generator().manual_seed(5)
    m2d = tile / 2 + 2.0 * torch.randn((n, 2), generator=g)
    conics = torch.tensor([0.01, 0.0, 0.01]).expand(n, 3).clone()
    colors = torch.rand((n, 5), generator=g)
    opac = 0.05 + 0.15 * torch.rand(n, generator=g)
    depths = torch.rand(n, generator=g)
    radii = torch.full((n,), 2.0 * tile)
    return [m2d, conics, colors, opac], depths, radii


def _saved_bytes(composite, tile: int) -> int:
    """Bytes of the distinct storages autograd keeps for the backward."""
    leaves, depths, radii = _one_tile(tile)
    leaves = [t.requires_grad_(True) for t in leaves]
    kept = {}

    def pack(t):
        s = t.untyped_storage()
        kept[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        r, a = composite(*leaves, depths, radii, tile, tile, tile=tile)
    torch.autograd.grad(r.sum() + a.sum(), leaves)
    return sum(kept.values())


def test_saved_bytes_do_not_grow_with_the_tile_s_pixels():
    from reference import core

    new = {tile: _saved_bytes(core.composite, tile) for tile in (16, 32)}
    old = {tile: _saved_bytes(former_composite, tile) for tile in (16, 32)}
    assert new[16] == new[32], new
    assert old[32] > 3 * old[16], old  # the former form's grew with P = tile^2
    assert 20 * new[16] < old[16], (new, old)


def test_recompute_loads_no_compiler_stack():
    """The backward's recompute imports neither sympy nor torch._dynamo
    (as `grad_outputs` and `torch.utils.checkpoint` do on their first
    call): seconds of every run's set-up. In a fresh process."""
    import subprocess
    import sys

    from helpers import FGBENCH

    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch, helpers\n"
        "from test_fgbench_reference import case\n"
        "from reference import core\n"
        "m2d, conics, colors, opac, depths, rad, _ = case()\n"
        "leaves = [t.requires_grad_(True) for t in (m2d, conics, colors, opac)]\n"
        "r, a = core.composite(*leaves, depths, rad, 40, 24)\n"
        "torch.autograd.grad(r.sum() + a.sum(), leaves)\n"
        "print(sorted(m for m in ('sympy', 'torch._dynamo') if m in sys.modules))\n"
    ) % (str(FGBENCH / "tests"), str(FGBENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
