"""The field MLPs over live rows only (`live=`, `ops/mlp_cuda.py`): on the
CPU the plain versions, which compute what the kernels compute with a live
mask, against the JAX package's Pallas kernels in interpret mode; the
plain versions with a mask against the same call without one; the device
block list against a numpy partition; and the guard that makes skipping
dead rows exact: in the training steps that pass `alive`, the cotangents of
the field outputs are exactly zero on dead rows.

Masks over 300 rows (three 128-row blocks): all live, a dead tail (the last
block dead), a dead middle block, one live row at row 127, none live, and
holes inside live blocks beside a dead block. The JAX kernels compute every
row; the comparison reads the live rows, with the cotangent zero on the
dead rows on both sides (as every consumer of the fields gives it).

Tolerances (tests/test_torch_deform_fused.py's, the same numerics):
outputs on live rows max |diff| / max |JAX| < 1e-2 and normwise < 5e-3;
gradients normwise < 3e-2. Against the `live=None` call: the rows of live
blocks bit-equal in the outputs and the data gradients, and, the dead
cotangents being zeros, the weight and bias gradients bit-equal too (the
plain versions sum the same products; the kernels split their sums
elsewhere, which `tests/test_torch_kernels_cuda.py` holds to the budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.ops.mlp_pallas import fused_control_trunk, fused_deform_full, fused_deform_trunk
from freegaussian_tpu.ops.mlp_pallas import fused_trunk as j_fused_trunk
from freegaussian_tpu_torch.engine.control_train_step import make_control_train_step
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
from freegaussian_tpu_torch.engine.train_step import create_train_state, make_train_step
from freegaussian_tpu_torch.models import fields
from freegaussian_tpu_torch.models.bilagrid import init_bilateral_grids
from freegaussian_tpu_torch.models.camera_opt import init_camera_opt
from freegaussian_tpu_torch.models.densify import DensifyConfig
from freegaussian_tpu_torch.models.splat_model import SplatConfig, make_control_field, make_deform_field
from freegaussian_tpu_torch.ops import mlp_cuda
from test_torch_deform_fused import BLOCK, OUT_MAX_REL, OUT_NORM_REL, _close, _trunk
from test_torch_parallel import _join, _spawn
from torch_port_helpers import camera_arrays, gaussian_scene_3d, torch_camera

N = 300
MODES = ["heads", "control", "deform-trunk", "trunk"]


def _mask(name, n=N):
    r = np.arange(n)
    if name == "all":
        return np.ones(n, bool)
    if name == "dead-tail":
        return r < 200  # block 1 partly live (rows 200-255 dead inside it), block 2 dead
    if name == "dead-middle":
        return (r < 128) | (r >= 256)
    if name == "row-127":
        return r == 127
    if name == "none":
        return np.zeros(n, bool)
    if name == "holed":
        rng = np.random.default_rng(n)
        return (rng.uniform(size=n) < 0.3) & ((r < 128) | (r >= 256))
    raise ValueError(name)


MASKS = ["all", "dead-tail", "dead-middle", "row-127", "none", "holed"]


def _block_rows(live):
    """(N,) bool: the row's 128-row block holds a live row (numpy)."""
    n = live.shape[0]
    pad = np.zeros(-(-n // 128) * 128, bool)
    pad[:n] = live
    return np.repeat(pad.reshape(-1, 128).any(1), 128)[:n]


_CASES = {}


def _case(mode):
    """Seeded inputs of one mode of the field kernels and the JAX Pallas
    forward with its VJP, jitted once a mode: (inputs, JAX output,
    vjp(cotangent) -> the JAX gradients)."""
    if mode in _CASES:
        return _CASES[mode]
    rng = np.random.default_rng(MODES.index(mode) + 11)
    x = rng.normal(size=(N, 3)).astype(np.float32)
    value = rng.normal(scale=0.3, size=(N, 3)).astype(np.float32)
    t = rng.normal(size=(1, 30)).astype(np.float32)
    in_ch = {"heads": 93, "control": 126, "deform-trunk": 93, "trunk": 93}[mode]
    ws, bs, hws, hbs = _trunk(rng, in_ch)
    x_emb = rng.normal(size=(N, 63)).astype(np.float32)
    J = lambda arrs: [jnp.asarray(a) for a in arrs]
    if mode == "heads":
        fn = lambda *a: fused_deform_full(*a, interpret=True, block=BLOCK)
        args = (jnp.asarray(x), jnp.asarray(t), J(ws), J(bs), J(hws), J(hbs))
    elif mode == "control":
        fn = lambda *a: fused_control_trunk(*a, interpret=True, block=BLOCK)
        args = (jnp.asarray(x), jnp.asarray(value), J(ws), J(bs))
    elif mode == "deform-trunk":
        fn = lambda *a: fused_deform_trunk(*a, interpret=True, block=BLOCK)
        args = (jnp.asarray(x), jnp.asarray(t), J(ws), J(bs))
    else:
        fn = lambda *a: j_fused_trunk(*a, interpret=True, block=BLOCK)
        args = (jnp.asarray(x_emb), jnp.asarray(t), J(ws), J(bs))
    out, vjp = jax.vjp(fn, *args)
    vjp = jax.jit(vjp)
    inputs = dict(x=x, value=value, t=t, ws=ws, bs=bs, hws=hws, hbs=hbs, x_emb=x_emb)
    _CASES[mode] = (inputs, np.asarray(out), vjp)
    return _CASES[mode]


def _port(mode, inputs, live, cot):
    """The port's differentiable call on CPU tensors with `live`, and its
    backward from `cot`: (output, {name: gradient})."""
    T = lambda a: torch.tensor(np.ascontiguousarray(a), requires_grad=True)
    wt, bt = [T(w.T) for w in inputs["ws"]], [T(b) for b in inputs["bs"]]
    live_t = None if live is None else torch.tensor(live)
    leaves = {}
    if mode == "heads":
        leaves = dict(x=T(inputs["x"]), t=T(inputs["t"][0]), hw=T(np.concatenate(inputs["hws"], 1).T),
                      hb=T(np.concatenate(inputs["hbs"])))
        out = mlp_cuda.deform_field(leaves["x"], leaves["t"], wt, bt, leaves["hw"], leaves["hb"], live=live_t)
    elif mode == "control":
        leaves = dict(x=T(inputs["x"]), value=T(inputs["value"]))
        out = mlp_cuda.field_trunk(leaves["x"], leaves["value"], None, wt, bt, live=live_t)
    elif mode == "deform-trunk":
        leaves = dict(x=T(inputs["x"]), t=T(inputs["t"][0]))
        out = mlp_cuda.field_trunk(leaves["x"], None, leaves["t"], wt, bt, live=live_t)
    else:
        leaves = dict(x=T(inputs["x_emb"]), t=T(inputs["t"]))
        out = mlp_cuda.fused_trunk(leaves["x"], leaves["t"], wt, bt, live=live_t)
    before = dict(mlp_cuda.LAUNCHES)
    out.backward(torch.tensor(cot))
    assert mlp_cuda.LAUNCHES == before  # CPU tensors: the plain versions, no launch
    grads = {k: v.grad for k, v in leaves.items()}
    grads.update({f"dW{i}": w.grad for i, w in enumerate(wt)}, **{f"db{i}": b.grad for i, b in enumerate(bt)})
    return out.detach(), grads


def _jax_grads(mode, jgrads):
    """The JAX VJP's gradients by the port's names (weights transposed)."""
    if mode == "heads":
        gx, gt, gws, gbs, ghws, ghbs = jgrads
        out = dict(x=gx, t=gt[0], hw=np.concatenate([np.asarray(a) for a in ghws], 1).T,
                   hb=np.concatenate([np.asarray(a) for a in ghbs]))
    else:
        g0, g1, gws, gbs = jgrads
        out = dict(x=g0, **({"value": g1} if mode == "control" else {"t": g1[0] if mode == "deform-trunk" else g1}))
    out.update({f"dW{i}": np.asarray(w).T for i, w in enumerate(gws)}, **{f"db{i}": b for i, b in enumerate(gbs)})
    return out


def _cotangent(mode, live):
    rng = np.random.default_rng(7)
    cot = rng.normal(size=(N, 13 if mode == "heads" else 256)).astype(np.float32)
    return cot * live[:, None]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_with_live_matches_jax_pallas_on_live_rows(mode, mask):
    """The plain versions with `live` against the Pallas kernels: the output
    on live rows within the forward's budget, zero on the rows of blocks
    with no live row, finite everywhere; every gradient of a cotangent that
    is zero on dead rows (dx on live rows, the weights, the time row)."""
    inputs, j_out, vjp = _case(mode)
    live = _mask(mask)
    cot = _cotangent(mode, live)
    out, grads = _port(mode, inputs, live, cot)
    assert torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in grads.values())
    dead_blocks = ~_block_rows(live)
    assert not out[torch.tensor(dead_blocks)].any()
    if live.any():
        _close(out[torch.tensor(live)], j_out[live], "out", OUT_MAX_REL, OUT_NORM_REL)
    want = _jax_grads(mode, vjp(jnp.asarray(cot)))
    for name, g in grads.items():
        if name in ("x", "value"):
            assert not g[torch.tensor(dead_blocks)].any(), name  # dx is zero on dead blocks
            g, w = g[torch.tensor(live)], np.asarray(want[name])[live]
        else:
            w = want[name]
        w = np.asarray(w)
        if not np.abs(w).any():
            assert not g.any(), name  # no live row: exact zeros on both sides
        else:
            _close(g, w, name)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_live_rows_equal_the_unmasked_call(mode, mask):
    """Rows of live blocks bit-equal to the `live=None` call in the output
    and the data gradients; with the cotangent zero on dead rows, every
    weight and bias gradient bit-equal too."""
    inputs, _, _ = _case(mode)
    live = _mask(mask)
    cot = _cotangent(mode, live)
    out, grads = _port(mode, inputs, live, cot)
    out0, grads0 = _port(mode, inputs, None, cot)
    keep = torch.tensor(_block_rows(live))
    assert torch.equal(out[keep], out0[keep])
    for name, g in grads.items():
        if name in ("x", "value"):  # per-row data gradients
            assert torch.equal(g[keep], grads0[name][keep]), name
        else:
            assert torch.equal(g, grads0[name]), name


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, N, 517])
def test_block_list_is_a_stable_partition(n):
    """`live_blocks`: the blocks holding a live row in row order, then the
    others in row order, then the live count; int32 on the mask's device."""
    rng = np.random.default_rng(n)
    masks = [np.zeros(n, bool), np.ones(n, bool)] + [rng.uniform(size=n) < p for p in (0.002, 0.01, 0.3)]
    if n == N:
        masks += [_mask(m) for m in MASKS]
    for live in masks:
        got = mlp_cuda.live_blocks(torch.tensor(live))
        pad = np.zeros(mlp_cuda._padded_rows(n), bool)
        pad[:n] = live
        flags = pad.reshape(-1, mlp_cuda.ROWS).any(1)
        want = np.concatenate([np.flatnonzero(flags), np.flatnonzero(~flags), [flags.sum()]])
        assert got.dtype == torch.int32 and got.device == torch.device("cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_live_is_checked():
    """`live` must be an (N,) bool tensor on the data's device."""
    x, t_row = torch.zeros(5, 3), torch.zeros(30)
    wpack = torch.zeros(mlp_cuda.OFFSETS[-1], dtype=torch.bfloat16)
    bias, hw, hb = torch.zeros(8, 256), torch.zeros(13, 256), torch.zeros(13)
    call = lambda live: mlp_cuda.deform_field_fwd(x, t_row, wpack, bias, hw, hb, 63, False, live=live)
    with pytest.raises(TypeError, match="live"):
        call(torch.ones(5))
    with pytest.raises(ValueError, match="live"):
        call(torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="live"):  # another device than the data's
        call(torch.ones(5, dtype=torch.bool, device="meta"))


# --- the guard: zero cotangents on dead rows in the training steps ----------------

CAPACITY = 400  # four 128-row blocks
W, H = 48, 32


def _guard_alive():
    """Live rows with holes in block 0, block 1 dead, block 2 partly live,
    block 3 dead; the dead rows keep stale (non-zero) parameters."""
    r = np.arange(CAPACITY)
    alive = ((r < 128) & (r % 17 != 5)) | ((r >= 256) & (r < 320))
    return torch.tensor(alive)


def _guard_params(seed):
    params, _ = gaussian_scene_3d(n=CAPACITY, seed=seed)
    return {k: torch.tensor(v) for k, v in params.items()}


def _hook_field_outputs(monkeypatch, name):
    """Wrap `fields.<name>` to record each call's `live` and the cotangent
    of its output."""
    calls, cots = [], []
    real = getattr(fields, name)

    def hooked(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(kwargs.get("live"))
        if out.requires_grad:
            out.register_hook(lambda g: cots.append(g.detach().clone()))
        return out

    monkeypatch.setattr(fields, name, hooked)
    return calls, cots


def _assert_dead_rows_zero(alive, calls, cots, want_calls, want_cots):
    assert len(calls) == want_calls and len(cots) == want_cots, (len(calls), len(cots))
    for live in calls:
        assert live is not None and torch.equal(live, alive)  # the path passes alive
    for g in cots:
        assert g.shape[0] == CAPACITY
        assert torch.count_nonzero(g[~alive]) == 0  # exactly zero on every dead row
        assert g[alive].abs().max() > 0


def test_stage1_step_cotangents_are_zero_on_dead_rows(monkeypatch):
    """One stage-1 step with both flow losses, camera optimization (SO3xR3)
    and the bilateral grid, the deform field on the fused kernel path: both
    deform calls (the frame's time and the paired frame's) get `alive`, and
    the cotangents of their outputs are exactly zero on dead rows."""
    calls, cots = _hook_field_outputs(monkeypatch, "deform_field")
    cfg = SplatConfig(warm_up=0, tile_size=16, background_color="random", flow_loss_weight=0.01,
                      flow_3d_loss_weight=0.1, flow_px_ref=128, camera_optimizer_mode="SO3xR3",
                      use_bilateral_grid=True, deform_impl="fused")
    gen = torch.Generator().manual_seed(3)
    deform = make_deform_field(cfg).reset_parameters(gen).requires_grad_(True)
    optimizers = make_optimizers(OptimizersConfig(max_steps=1000))
    alive = _guard_alive()
    state = create_train_state(
        _guard_params(31), alive, deform, optimizers, generator=torch.Generator().manual_seed(4),
        camera_opt=0.01 * torch.randn(1, 6, generator=gen) + init_camera_opt(1, device="cpu"),
        bilagrid=init_bilateral_grids(1, device="cpu") + 0.02 * torch.randn(1, 8, 16, 16, 12, generator=gen),
    )
    step = make_train_step(cfg, DensifyConfig(refine_start=10**9), optimizers, num_train_data=1)
    rng = np.random.default_rng(5)
    batch = {
        "image": torch.tensor(rng.uniform(size=(H, W, 3)).astype(np.float32)),
        "flow": torch.tensor(rng.normal(scale=1.5, size=(H, W, 2)).astype(np.float32)),
        "depth0": torch.tensor(rng.uniform(3.0, 5.0, size=(H, W, 1)).astype(np.float32)),
    }
    cam, cam0 = (torch_camera(camera_arrays(width=W, height=H, time=t)) for t in (0.6, 0.45))
    state, metrics = step(state, cam, batch, 3, camera0=cam0)
    assert bool(metrics["params_finite"]) and float(metrics["flow_3d"]) > 0
    _assert_dead_rows_zero(alive, calls, cots, 2, 2)


def test_control_step_cotangents_are_zero_on_dead_rows(monkeypatch):
    """One stage-2 step under deform_impl "pallas": the two deform-trunk
    calls of the control state (no gradient) and the control trunk get
    `alive`, and the control trunk's output cotangent is exactly zero on
    dead rows."""
    calls, cots = _hook_field_outputs(monkeypatch, "field_trunk")
    cfg = SplatConfig(warm_up=0, tile_size=16, background_color="random", deform_impl="pallas")
    gen = torch.Generator().manual_seed(6)
    deform = make_deform_field(cfg).reset_parameters(gen, 0.1).requires_grad_(False)
    control = make_control_field(cfg).reset_parameters(gen)
    optimizers = make_optimizers(OptimizersConfig(max_steps=1000))
    alive = _guard_alive()
    state = create_train_state(_guard_params(32), alive, deform, optimizers,
                               generator=torch.Generator().manual_seed(7), control=control)
    rng = np.random.default_rng(8)
    mask = torch.tensor(rng.uniform(size=(CAPACITY, 3)) < 0.5)
    step = make_control_train_step(cfg, optimizers, mask, 0.2)
    image = torch.tensor(rng.uniform(size=(H, W, 3)).astype(np.float32))
    state, metrics = step(state, torch_camera(camera_arrays(width=W, height=H, time=0.7)), {"image": image}, 3)
    assert bool(metrics["params_finite"])
    _assert_dead_rows_zero(alive, calls, cots, 3, 1)


def test_parallel_step_cotangents_are_zero_on_dead_rows(tmp_path):
    """The multi-GPU step at (data 1, tile 2) over gloo, two processes, with
    primitive sharding (each rank runs the deform field on its half of the
    capacity) and both flow losses: each rank's two deform calls get its
    slice of `alive`, and their output cotangents are exactly zero on its
    dead rows (rank 0's second block and rank 1's tail are whole dead
    blocks)."""
    alive = _guard_alive()
    rng = np.random.default_rng(9)
    cams = [camera_arrays(width=W, height=H, time=0.6)]
    case = dict(
        kind="guard", seed=10, hw=(H, W), params=_guard_params(33), alive=alive,
        model=dict(warm_up=0, tile_size=16, background_color="random", flow_loss_weight=0.01,
                   flow_3d_loss_weight=0.1, deform_impl="fused"),
        cams=cams, cams0=[dict(cams[0], time=np.float32(0.45))],
        images=torch.tensor(rng.uniform(size=(1, H, W, 3)).astype(np.float32)),
        flows=torch.tensor(rng.normal(scale=1.5, size=(1, H, W, 2)).astype(np.float32)),
        depth0s=torch.tensor(rng.uniform(3.0, 5.0, size=(1, H, W, 1)).astype(np.float32)),
    )
    case_dir = tmp_path / "case"
    case_dir.mkdir()
    torch.save(case, case_dir / "case.pt")
    results = _join(_spawn(case_dir, 2), case_dir)
    half = CAPACITY // 2
    for rank, res in enumerate(results):
        mine = alive[rank * half:(rank + 1) * half]
        assert np.isfinite(res["loss"]) and len(res["live"]) == 2 and len(res["cotangents"]) == 2
        for live in res["live"]:
            assert torch.equal(live, mine)
        for g in res["cotangents"]:
            assert g.shape[0] == half and torch.count_nonzero(g[~mine]) == 0
            assert g[mine].abs().max() > 0
