"""The CUDA tile compositor and its backward, and the field-MLP kernel pair
(the fused deform field with its heads, the field trunk of the deform and
control fields), against their plain PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and skips
without a card. The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance: atol 2e-5 on color, alpha and t_final (the kernel sums a pixel's
colors in walk order, the plain version as one contraction: f32 summation
order only); livecnt is exact, since both round every product and sum of
the termination test alike. Backward rows: rtol 1e-3 / atol 1e-4, the JAX
package's gradient budget (the kernel rebuilds T by dividing by 1 - alpha,
the plain version differentiates the running product). Deform field: outputs
max |diff| / max |plain| < 1e-2 and normwise < 5e-3 (bf16 activations round
alike except where the f32 sums, taken in another order, straddle a bf16
rounding boundary); the backward from the same saved activations, so with
the same ReLU masks, max 1e-2 and normwise 1e-3. The field trunk: the same
budgets on its bf16 output and its gradients, and the trunk on a
precomputed embedding the same. The forward-walk backward is held to the
backward's budget against the plain version and the reverse walk's kernel on
sparse and dense scenes (its suffix identity r_total - S cancels where the
suffix is small next to the pixel's total, which a dense scene reaches), and
its exactly-zero rows (slots past every pixel's termination) must be the
reverse walk's, which reads the forward's own live counts.
"""

import numpy as np
import pytest
import torch

from freegaussian_tpu_torch.ops import mlp_cuda, rasterize_cuda
from freegaussian_tpu_torch.ops.rasterize_cuda import (
    rasterize_pixels,
    rasterize_tiles,
    rasterize_tiles_bwd,
    rasterize_tiles_bwd_fwd,
    rasterize_tiles_bwd_plain,
    rasterize_tiles_plain,
    reduce_rows_by_gid,
)
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


def _cotangents(device, width, height, channels, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    g_color = torch.randn(height, width, channels, generator=g).to(device)
    g_alpha = torch.randn(height, width, generator=g).to(device)
    return g_color, g_alpha


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("channels", [3, 5, 8])
def test_cuda_bwd_kernel_matches_plain(cuda_device, channels, tile_size):
    args = _inputs(cuda_device, 600, 100, 70, channels, channels + 10, tile_size)
    _, _, livecnt, t_final = rasterize_tiles(*args)
    g_color, g_alpha = _cotangents(cuda_device, 100, 70, channels, channels)
    before = rasterize_cuda.LAUNCHES["rasterize_bwd"]
    got = rasterize_tiles_bwd(*args[:7], livecnt, t_final, g_color, g_alpha, *args[7:])
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES["rasterize_bwd"] == before + 1
    want = rasterize_tiles_bwd_plain(*args[:7], g_color, g_alpha, *args[7:])
    assert got.shape == want.shape == (args[5].shape[0], 8 + channels)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    assert (got[:, 6:8] >= 0).all() and (want.abs().sum(1) == 0).any()  # some rows past termination


@pytest.mark.cuda
def test_cuda_bwd_kernel_writes_every_row(cuda_device):
    """Rows of slots past every pixel's termination are written as zeros,
    whatever the freshly allocated output held."""
    args = _inputs(cuda_device, 400, 64, 48, 3, 21, 16)
    _, _, livecnt, t_final = rasterize_tiles(*args)
    g_color, g_alpha = _cotangents(cuda_device, 64, 48, 3, 1)
    n_rows = args[5].shape[0]
    poison = torch.full((n_rows, 11), float("nan"), device=cuda_device)
    del poison  # the caching allocator hands this block to the kernel's output
    rows = rasterize_tiles_bwd(*args[:7], livecnt, t_final, g_color, g_alpha, *args[7:])
    torch.cuda.synchronize()
    assert torch.isfinite(rows).all()
    assert (rows == 0).all(dim=1).any()


def _row_budget(scene, width, height, tile_size, weights):
    """Per-Gaussian gradient budget implied by the per-row one (rtol 1e-3 /
    atol 1e-4 on each intersection row): the sum over the Gaussian's rows of
    1e-4 + 1e-3 |row|, from the plain backward on the CPU with the loss's
    cotangents. Returns (N, 8 + C)."""
    m, con, col, op, dep, rad = [torch.tensor(a) for a in scene]
    isect = build_intersections(m, rad.float(), dep, width, height, tile_size)
    args = (m, con, col, op, rad.float(), isect.gauss_ids, isect.tile_offsets)
    _, alpha, _, _ = rasterize_tiles_plain(*args, width, height, tile_size)
    g_color = weights.expand(height, width, col.shape[1]).contiguous()
    rows = rasterize_tiles_bwd_plain(*args, g_color, 2 * alpha, width, height, tile_size)
    abs_sum = reduce_rows_by_gid(rows.abs(), isect.gauss_ids, isect.offsets, isect.counts)
    return 1e-4 * isect.counts[:, None].float() + 1e-3 * abs_sum


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
def test_cuda_pixel_stage_gradients_match_cpu(cuda_device, tile_size):
    """Autograd through the pixel stage on the card (both kernels) against
    the same on the CPU (both plain versions), absgrad sink included. Each
    Gaussian's gradient sums rows of either sign, so its budget is the sum
    of its rows' budgets (`_row_budget`)."""
    scene = clustered_scene_2d(n=300, width=80, height=60, seed=4, channels=5)
    weights = torch.linspace(-1, 1, 5)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        m, con, col, op, dep, rad = [torch.tensor(a, device=dev) for a in scene]
        leaves = [t.requires_grad_(True) for t in (m, con, col, op)]
        sink = torch.zeros_like(m, requires_grad=True)
        render, alpha, _ = rasterize_pixels(*leaves, dep, rad.float(), 80, 60, tile_size=tile_size, means2d_sink=sink)
        loss = (render * weights.to(dev)).sum() + (alpha ** 2).sum()
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, leaves + [sink])]
    budget = _row_budget(scene, 80, 60, tile_size, weights)
    cols = {"means2d": slice(0, 2), "conics": slice(2, 5), "colors": slice(8, 13), "opacities": 5, "absgrad": slice(6, 8)}
    worst = {}
    for name, a, b in zip(("means2d", "conics", "colors", "opacities", "absgrad"), grads["cuda"], grads["cpu"]):
        over = (a - b).abs() / budget[:, cols[name]].clamp(min=1e-30)  # no rows: both exactly 0
        worst[name] = float(over.max())
        assert worst[name] <= 1.0, (name, worst[name])
    print(f"tile {tile_size}: worst |GPU - CPU| / budget by group: {worst}")


def _deform_inputs(device, n, seed):
    """Seeded trunk and head weights (N(0, 1/fan_in) trunk, N(0, 1/256) heads),
    N(0, 1) points and time row, in the wrappers' packed layout."""
    rng = np.random.default_rng(seed)
    in_ch = 63 + 30
    fan_in = [in_ch] + [256] * 7
    fan_in[5] = in_ch + 256
    ws = [torch.tensor(rng.normal(size=(256, f)) / np.sqrt(f), dtype=torch.float32) for f in fan_in]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return (
        t(rng.normal(size=(n, 3))), t(rng.normal(size=30)), mlp_cuda.pack_trunk(ws, in_ch).to(device),
        t(rng.normal(size=(8, 256)) * 0.01), t(rng.normal(size=(13, 256)) / 16), t(rng.normal(size=13) * 0.01), 63,
    )


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max()), float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 200, 5000])
def test_cuda_deform_fwd_matches_plain(cuda_device, n):
    args = _deform_inputs(cuda_device, n, n)
    before = mlp_cuda.LAUNCHES["deform_fwd"]
    y, (emb, acts) = mlp_cuda.deform_field_fwd(*args, True)
    y_serve, saved = mlp_cuda.deform_field_fwd(*args, False)
    torch.cuda.synchronize()
    assert mlp_cuda.LAUNCHES["deform_fwd"] == before + 2 and saved is None
    assert torch.equal(y, y_serve)
    yp, (embp, actsp) = mlp_cuda.deform_field_fwd_plain(*args, True)
    mx, nm = _rel(y, yp)
    assert mx <= 1e-2 and nm <= 5e-3, (mx, nm)
    # the saved bf16 tensors: the embedding and the first layer (one product
    # from identical inputs) round alike but for rare f32 near-ties; deeper
    # layers inherit those differences, and the output budget above bounds them
    mismatch = [int((acts[i, :n] != actsp[i, :n]).sum()) for i in range(8)]
    print(f"n {n}: embedding mismatches {int((emb != embp).sum())}, activation mismatches by layer {mismatch} of {n * 256}")
    assert int((emb != embp).sum()) <= max(1, emb.numel() // 1000)
    assert mismatch[0] <= max(1, n * 256 // 1000)


@pytest.mark.cuda
def test_cuda_deform_bwd_matches_plain(cuda_device):
    n = 3000
    args = _deform_inputs(cuda_device, n, 7)
    _, (emb, acts) = mlp_cuda.deform_field_fwd(*args, True)
    g = torch.Generator(device="cpu").manual_seed(8)
    dy = torch.randn(n, 13, generator=g).to(cuda_device)
    bargs = (args[0], dy, args[2], args[4], emb, acts, args[6])
    before = mlp_cuda.LAUNCHES["deform_bwd"]
    got = mlp_cuda.deform_field_bwd(*bargs)
    torch.cuda.synchronize()
    assert mlp_cuda.LAUNCHES["deform_bwd"] == before + 1
    want = mlp_cuda.deform_field_bwd_plain(*bargs)
    for name, a, b in zip(("dx", "d_emb", "dW", "dbias", "dhead_w", "dhead_b"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        mx, nm = _rel(a, b)
        assert mx <= 1e-2 and nm <= 1e-3, (name, mx, nm)


@pytest.mark.cuda
def test_cuda_deform_kernels_write_every_output_at_zero_rows(cuda_device):
    """No points: the forward still writes its saved tensors' padded rows,
    and the backward's weight gradients are exact zeros, whatever the freshly
    allocated buffers held."""
    args = _deform_inputs(cuda_device, 0, 5)
    poison = torch.full((8, 1 << 20), float("nan"), device=cuda_device)
    del poison  # the caching allocator hands this block to the wrappers' outputs
    y, (emb, acts) = mlp_cuda.deform_field_fwd(*args, True)
    assert y.shape == (0, 13) and torch.isfinite(emb).all() and torch.isfinite(acts).all()
    dy = torch.zeros(0, 13, device=cuda_device)
    got = mlp_cuda.deform_field_bwd(args[0], dy, args[2], args[4], emb, acts, args[6])
    torch.cuda.synchronize()
    assert got[0].shape == (0, 3)
    for g in got[1:]:
        assert torch.equal(g, torch.zeros_like(g))


@pytest.mark.cuda
def test_cuda_deform_field_gradients_match_cpu(cuda_device):
    """`deform_field` under autograd on the card (both kernels) against the
    CPU (both plain versions): every gradient normwise within 3e-2, the
    budget of tests/test_torch_deform_fused.py (the forward's roundings may
    differ, and a flipped ReLU mask moves single elements fully)."""
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        x, t_row, wpack, bias, hw, hb, _ = _deform_inputs(dev, 700, 11)
        ws = [w.float().requires_grad_(True) for w in mlp_cuda.unpack_trunk(wpack.float(), 93)]
        leaves = [t_row.requires_grad_(True), hw.requires_grad_(True), hb.requires_grad_(True)]
        bs = [b.clone().requires_grad_(True) for b in bias]
        y = mlp_cuda.deform_field(x, leaves[0], ws, bs, leaves[1], leaves[2])
        loss = (y * torch.linspace(-1, 1, 13, device=dev)).sum() + (y ** 2).sum()
        grads[dev.type] = [p.cpu() for p in torch.autograd.grad(loss, leaves + ws + bs)]
    for i, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
        _, nm = _rel(a, b)
        assert nm <= 3e-2, (i, nm)


def _field_inputs(device, n, seed, mode):
    """Seeded trunk weights and N(0, 1) sources in the trunk wrappers'
    layout: "control" two sources (positions, N(0, 0.3) control values),
    no time row; "deform" one source and a 30-lane time row."""
    rng = np.random.default_rng(seed)
    sources, t_lanes = (2, 0) if mode == "control" else (1, 30)
    in_ch = 63 * sources + t_lanes
    fan_in = [in_ch] + [256] * 7
    fan_in[5] = in_ch + 256
    ws = [torch.tensor(rng.normal(size=(256, f)) / np.sqrt(f), dtype=torch.float32) for f in fan_in]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    xsrc = np.concatenate([rng.normal(size=(n, 3)), rng.normal(scale=0.3, size=(n, 3))], axis=1)[:, : 3 * sources]
    return (
        t(np.ascontiguousarray(xsrc)), t(rng.normal(size=t_lanes)), mlp_cuda.pack_trunk(ws, in_ch).to(device),
        t(rng.normal(size=(8, 256)) * 0.01), sources, 63,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["control", "deform"])
@pytest.mark.parametrize("n", [1, 130, 5000])
def test_cuda_field_fwd_matches_plain(cuda_device, mode, n):
    args = _field_inputs(cuda_device, n, n + 1, mode)
    before = mlp_cuda.LAUNCHES["field_fwd"]
    h, (emb, acts) = mlp_cuda.field_trunk_fwd(*args, True)
    h_serve, saved = mlp_cuda.field_trunk_fwd(*args, False)
    torch.cuda.synchronize()
    assert mlp_cuda.LAUNCHES["field_fwd"] == before + 2 and saved is None
    assert h.shape == (n, 256) and h.dtype == torch.bfloat16
    assert torch.equal(h, h_serve) and torch.equal(h, acts[-1, :n])
    hp, (embp, actsp) = mlp_cuda.field_trunk_fwd_plain(*args, True)
    mx, nm = _rel(h.float(), hp.float())
    assert mx <= 1e-2 and nm <= 5e-3, (mx, nm)
    # the embedding rounds alike but for rare f32 near-ties of sin / cos
    assert int((emb != embp).sum()) <= max(1, emb.numel() // 1000)
    assert int((acts[0, :n] != actsp[0, :n]).sum()) <= max(1, n * 256 // 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["control", "deform"])
def test_cuda_field_bwd_matches_plain(cuda_device, mode):
    """From the same saved tensors (so the same ReLU masks): dxsrc, the row
    sum of d emb (its time lanes are dtrow), the packed dW and d bias."""
    n = 3000
    args = _field_inputs(cuda_device, n, 17, mode)
    xsrc, _, wpack, _, sources, x_lanes = args
    _, (emb, acts) = mlp_cuda.field_trunk_fwd(*args, True)
    g = torch.Generator(device="cpu").manual_seed(18)
    dh = torch.randn(n, 256, generator=g).to(cuda_device).bfloat16().float()
    bargs = (xsrc, dh, wpack, emb, acts, sources, x_lanes)
    before = mlp_cuda.LAUNCHES["field_bwd"]
    got = mlp_cuda.field_trunk_bwd(*bargs)
    torch.cuda.synchronize()
    assert mlp_cuda.LAUNCHES["field_bwd"] == before + 1
    want = mlp_cuda.field_trunk_bwd_plain(*bargs)
    assert got[0].shape == (n, 3 * sources)
    lanes = sources * x_lanes
    named = zip(("dxsrc", "d_emb", "dW", "dbias"), got, want)
    for name, a, b in list(named) + ([("dtrow", got[1][lanes : lanes + 30], want[1][lanes : lanes + 30])] if mode == "deform" else []):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        mx, nm = _rel(a, b)
        assert mx <= 1e-2 and nm <= 1e-3, (name, mx, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["control", "deform"])
def test_cuda_field_kernels_write_every_output(cuda_device, mode):
    """Every output row is written whatever the freshly allocated buffers
    held (the caching allocator hands the freed NaN block to the wrappers):
    at 130 rows, the forward's h and saved tensors and the backward's
    dxsrc; at no rows, the saved tensors' padded rows and exact-zero weight
    gradients."""
    for n in (130, 0):
        args = _field_inputs(cuda_device, n, 23, mode)
        poison = torch.full((8, 1 << 20), float("nan"), device=cuda_device)
        del poison
        h, (emb, acts) = mlp_cuda.field_trunk_fwd(*args, True)
        assert h.shape == (n, 256) and torch.isfinite(h).all()
        assert torch.isfinite(emb).all() and torch.isfinite(acts).all()
        dh = torch.ones(n, 256, device=cuda_device)
        poison = torch.full((8, 1 << 20), float("nan"), device=cuda_device)
        del poison
        got = mlp_cuda.field_trunk_bwd(args[0], dh, args[2], emb, acts, args[4], args[5])
        torch.cuda.synchronize()
        assert got[0].shape == (n, 3 * args[4]) and all(torch.isfinite(g).all() for g in got)
        if n == 0:
            for g in got[1:]:
                assert torch.equal(g, torch.zeros_like(g))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["control", "deform"])
def test_cuda_field_trunk_gradients_match_cpu(cuda_device, mode):
    """`field_trunk` under autograd on the card (both kernels) against the
    CPU (both plain versions): every gradient, the time row's and the
    positions' included, normwise within 3e-2."""
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        xsrc, t_row, wpack, bias, sources, _ = _field_inputs(dev, 700, 29, mode)
        in_ch = 63 * sources + t_row.shape[0]
        ws = [w.float().requires_grad_(True) for w in mlp_cuda.unpack_trunk(wpack.float(), in_ch)]
        bs = [b.clone().requires_grad_(True) for b in bias]
        x = xsrc[:, :3].clone().requires_grad_(True)
        value = xsrc[:, 3:].clone() if mode == "control" else None
        t_row = t_row.requires_grad_(True) if mode == "deform" else None
        h = mlp_cuda.field_trunk(x, value, t_row, ws, bs)
        loss = (h * torch.linspace(-1, 1, 256, device=dev)).sum() + (h ** 2).sum() * 1e-2
        leaves = [x] + ([t_row] if t_row is not None else []) + ws + bs
        grads[dev.type] = [p.cpu() for p in torch.autograd.grad(loss, leaves)]
    for i, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
        _, nm = _rel(a, b)
        assert nm <= 3e-2, (i, nm)


def _r_total(color, alpha, g_color, g_alpha):
    return ((color * g_color).sum(-1) + alpha * g_alpha).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("channels", [3, 5])
def test_cuda_bwd_fwd_walk_matches_plain(cuda_device, channels, tile_size, dense):
    """The forward walk on a sparse and a dense scene: every row within rtol
    1e-3 / atol 1e-4 of the plain backward and of the reverse walk's kernel,
    and zero exactly where the reverse walk's row is."""
    args = _inputs(cuda_device, 600, 100, 70, channels, channels + 30, tile_size, dense=dense)
    color, alpha, livecnt, t_final = rasterize_tiles(*args)
    g_color, g_alpha = _cotangents(cuda_device, 100, 70, channels, channels + 1)
    before = dict(rasterize_cuda.LAUNCHES)
    got = rasterize_tiles_bwd_fwd(*args[:7], livecnt, _r_total(color, alpha, g_color, g_alpha), g_color, g_alpha, *args[7:])
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES["rasterize_bwd_fwd"] == before["rasterize_bwd_fwd"] + 1
    assert rasterize_cuda.LAUNCHES["rasterize_bwd"] == before["rasterize_bwd"]
    want = rasterize_tiles_bwd_plain(*args[:7], g_color, g_alpha, *args[7:])
    rev = rasterize_tiles_bwd(*args[:7], livecnt, t_final, g_color, g_alpha, *args[7:])
    assert got.shape == want.shape == (args[5].shape[0], 8 + channels)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got, rev, rtol=1e-3, atol=1e-4)
    assert torch.equal((got == 0).all(1), (rev == 0).all(1))
    assert (got[:, 6:8] >= 0).all()


@pytest.mark.cuda
def test_cuda_bwd_fwd_walk_writes_every_row(cuda_device):
    """Rows past every pixel's termination are exact zeros whatever the
    freshly allocated output held; the walk stops where the forward did:
    its zero rows are the reverse walk's."""
    args = _inputs(cuda_device, 400, 64, 48, 3, 21, 16)
    color, alpha, livecnt, t_final = rasterize_tiles(*args)
    g_color, g_alpha = _cotangents(cuda_device, 64, 48, 3, 1)
    r_total = _r_total(color, alpha, g_color, g_alpha)
    poison = torch.full((args[5].shape[0], 11), float("nan"), device=cuda_device)
    del poison  # the caching allocator hands this block to the kernel's output
    rows = rasterize_tiles_bwd_fwd(*args[:7], livecnt, r_total, g_color, g_alpha, *args[7:])
    torch.cuda.synchronize()
    assert torch.isfinite(rows).all()
    assert (rows == 0).all(dim=1).any()
    rev = rasterize_tiles_bwd(*args[:7], livecnt, t_final, g_color, g_alpha, *args[7:])
    assert torch.equal((rows == 0).all(1), (rev == 0).all(1))


def _trunk_inputs(device, n, seed, in_ch=93):
    rng = np.random.default_rng(seed)
    fan_in = [in_ch] + [256] * 7
    fan_in[5] = in_ch + 256
    ws = [torch.tensor(rng.normal(size=(256, f)) / np.sqrt(f), dtype=torch.float32) for f in fan_in]
    inp = np.zeros((n, 128), np.float32)
    inp[:, :in_ch] = rng.normal(size=(n, in_ch))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return t(inp), mlp_cuda.pack_trunk(ws, in_ch).to(device), t(rng.normal(size=(8, 256)) * 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 130, 5000])
def test_cuda_trunk_fwd_matches_plain(cuda_device, n):
    args = _trunk_inputs(cuda_device, n, n + 3)
    before = mlp_cuda.LAUNCHES["trunk_fwd"]
    h, (emb, acts) = mlp_cuda.trunk_fwd(*args, True)
    h_serve, saved = mlp_cuda.trunk_fwd(*args, False)
    torch.cuda.synchronize()
    assert mlp_cuda.LAUNCHES["trunk_fwd"] == before + 2 and saved is None
    assert h.shape == (n, 256) and h.dtype == torch.bfloat16
    assert torch.equal(h, h_serve) and torch.equal(h, acts[-1, :n])
    hp, (embp, actsp) = mlp_cuda.trunk_fwd_plain(*args, True)
    assert torch.equal(emb, embp)  # the given lanes rounded to bf16, zero padded rows
    mx, nm = _rel(h.float(), hp.float())
    assert mx <= 1e-2 and nm <= 5e-3, (mx, nm)


@pytest.mark.cuda
def test_cuda_trunk_bwd_matches_plain(cuda_device):
    """From the same saved tensors: d emb (N, 128), the packed dW, d bias."""
    n = 3000
    inp, wpack, bias = _trunk_inputs(cuda_device, n, 19)
    _, (emb, acts) = mlp_cuda.trunk_fwd(inp, wpack, bias, True)
    g = torch.Generator(device="cpu").manual_seed(20)
    dh = torch.randn(n, 256, generator=g).to(cuda_device).bfloat16().float()
    before = mlp_cuda.LAUNCHES["trunk_bwd"]
    got = mlp_cuda.trunk_bwd(dh, wpack, emb, acts)
    torch.cuda.synchronize()
    assert mlp_cuda.LAUNCHES["trunk_bwd"] == before + 1
    want = mlp_cuda.trunk_bwd_plain(dh, wpack, emb, acts)
    assert got[0].shape == (n, 128) and not got[0][:, 93:].any()
    for name, a, b in zip(("d_emb", "dW", "dbias"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        mx, nm = _rel(a, b)
        assert mx <= 1e-2 and nm <= 1e-3, (name, mx, nm)


@pytest.mark.cuda
def test_cuda_trunk_kernels_write_every_output(cuda_device):
    """Over a freed NaN-filled block: h, the saved tensors and d emb are
    written in full at 130 rows; at no rows the weight gradients are zeros."""
    for n in (130, 0):
        inp, wpack, bias = _trunk_inputs(cuda_device, n, 24)
        poison = torch.full((8, 1 << 20), float("nan"), device=cuda_device)
        del poison
        h, (emb, acts) = mlp_cuda.trunk_fwd(inp, wpack, bias, True)
        assert h.shape == (n, 256) and torch.isfinite(h).all()
        assert torch.isfinite(emb).all() and torch.isfinite(acts).all()
        poison = torch.full((8, 1 << 20), float("nan"), device=cuda_device)
        del poison
        got = mlp_cuda.trunk_bwd(torch.ones(n, 256, device=cuda_device), wpack, emb, acts)
        torch.cuda.synchronize()
        assert got[0].shape == (n, 128) and all(torch.isfinite(g).all() for g in got)
        if n == 0:
            for g in got[1:]:
                assert torch.equal(g, torch.zeros_like(g))


@pytest.mark.cuda
def test_cuda_fused_trunk_gradients_match_cpu(cuda_device):
    """`fused_trunk` under autograd on the card against the CPU: the
    gradients of x_emb, a broadcast t_emb and every weight, normwise 3e-2."""
    grads = {}
    rng = np.random.default_rng(31)
    x_np = rng.normal(size=(700, 63)).astype(np.float32)
    t_np = rng.normal(size=(1, 30)).astype(np.float32)
    for dev in (cuda_device, torch.device("cpu")):
        _, wpack, bias = _trunk_inputs(dev, 1, 30)
        ws = [w.float().requires_grad_(True) for w in mlp_cuda.unpack_trunk(wpack.float(), 93)]
        bs = [b.clone().requires_grad_(True) for b in bias]
        x = torch.tensor(x_np, device=dev, requires_grad=True)
        t = torch.tensor(t_np, device=dev, requires_grad=True)
        h = mlp_cuda.fused_trunk(x, t, ws, bs)
        loss = (h * torch.linspace(-1, 1, 256, device=dev)).sum() + (h ** 2).sum() * 1e-2
        grads[dev.type] = [p.cpu() for p in torch.autograd.grad(loss, [x, t] + ws + bs)]
    for i, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
        _, nm = _rel(a, b)
        assert nm <= 3e-2, (i, nm)
