"""Adam's one-pass update (`ops/adam_cuda.py`) on the CPU, where it runs its
plain version:

  - `apply_group_updates(..., alive=)` and `adam_update(..., alive=)` equal,
    bit for bit, the steps' former update (a `torch.where` on the Gaussian
    groups' gradients, then Adam one tensor at a time), for the groups of
    both training steps, with a holed mask, NaN and inf in dead rows'
    gradients, a missing gradient, and the scalars as host values or as a
    device table's rows; only the groups that the caller names are masked;
  - every training step's groups fit one launch of the kernel;
  - the launch plan (the table split at the kernel's parameter limit, row
    widths, work items) and the kernel's parameter table, as plain Python;
  - the kernel's argument checks, on meta tensors (a Gaussian gradient may
    be a slice of the SH coefficients' gradient, read by row stride).

The kernel itself is held to the plain version on the card in
tests/test_torch_adam_cuda.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from freegaussian_tpu_torch.engine.optimizers import (
    OptimizersConfig,
    adam_scalars,
    adam_update,
    apply_group_updates,
    init_opt_states,
    make_optimizers,
)
from freegaussian_tpu_torch.engine.train_step import GAUSSIAN_GROUPS, params_by_group
from freegaussian_tpu_torch.models.fields import ControlField, DeformField
from freegaussian_tpu_torch.ops import adam_cuda

N = 300
SHAPES = {"means": (3,), "scales": (3,), "quats": (4,), "features_dc": (3,), "features_rest": (45,), "opacities": (1,)}


def _bits(t):
    return t.contiguous().view(torch.int32)


def _gaussians(rng):
    return {k: torch.tensor(rng.normal(size=(N,) + s), dtype=torch.float32) for k, s in SHAPES.items()}


def _alive(rng):
    alive = torch.tensor(rng.uniform(size=N) < 0.6)
    alive[200:] = False  # the padded tail of a trainer's capacity
    return alive


def _grads(groups, alive, rng):
    """Seeded gradients; NaN and inf in the Gaussian groups' dead rows, and
    one field tensor without a gradient (an unused leaf)."""
    out = {}
    for g, ps in groups.items():
        out[g] = {}
        for k, p in ps.items():
            v = torch.tensor(rng.normal(scale=1e-2, size=tuple(p.shape)), dtype=torch.float32)
            if g in GAUSSIAN_GROUPS:
                dead = torch.nonzero(~alive)[:, 0]
                v[dead[::2]] = float("nan")
                v[dead[1::2]] = float("inf")
            out[g][k] = v
    field = next(g for g in groups if g not in GAUSSIAN_GROUPS)
    out[field][next(iter(groups[field]))] = None
    return out


def _former_update(optimizers, opt_states, groups, grads_by_group, alive, scalars=None):
    """The steps' update before the one-pass kernel, as they wrote it."""
    masked = {
        g: {
            k: torch.where(alive.reshape((-1,) + (1,) * (v.ndim - 1)), v, torch.zeros_like(v))
            if v is not None and g in GAUSSIAN_GROUPS else v
            for k, v in ps.items()
        }
        for g, ps in grads_by_group.items()
    }
    for name, params in groups.items():
        opt, state = optimizers[name], opt_states[name]
        if scalars is None:
            neg_lr, inv_bc1, inv_bc2 = adam_scalars(opt, state.count)
        else:
            neg_lr, inv_bc1, inv_bc2 = scalars[name][0], scalars[name][1], scalars[name][2]
        for k, p in params.items():
            g = masked[name].get(k)
            if g is None:
                g = torch.zeros_like(p)
            mu, nu = state.mu[k], state.nu[k]
            mu.mul_(opt.b1).add_(g * (1 - opt.b1))
            nu.mul_(opt.b2).add_((g * g) * (1 - opt.b2))
            update = (mu * inv_bc1) / (torch.sqrt(nu * inv_bc2) + opt.eps)
            p.add_(update * neg_lr)
        state.count += 1


def _clone(groups):
    return {g: {k: p.clone() for k, p in ps.items()} for g, ps in groups.items()}


@pytest.mark.parametrize("scalars", ["host", "rows"])
@pytest.mark.parametrize("stage", [1, 2])
def test_group_updates_equal_the_former_update(stage, scalars):
    """Two steps of both training steps' groups from a state with moments."""
    torch.manual_seed(0)
    rng = np.random.default_rng(stage)
    gaussians, alive = _gaussians(rng), _alive(rng)
    # the fields' tensors as the steps' groups hold them, at width 32 to keep the CPU's chain cheap
    field = DeformField(width=32) if stage == 1 else ControlField(width=32)
    groups = params_by_group(gaussians, field, None) if stage == 1 else params_by_group(gaussians, None, field)
    # the fields' own initialisation is the trainer's: seeded weights here
    groups = {g: {k: torch.tensor(rng.normal(scale=0.1, size=tuple(p.shape)), dtype=torch.float32) for k, p in ps.items()}
              for g, ps in groups.items()}
    optimizers = make_optimizers(OptimizersConfig(max_steps=100))
    sides = []
    for _ in range(2):
        params = _clone(groups)
        states = init_opt_states(optimizers, params)
        for g, st in states.items():
            st.count = 5
            for moments, scale in ((st.mu, 1e-2), (st.nu, 1e-4)):
                for k in moments:
                    moments[k].copy_(torch.tensor(np.abs(np.random.default_rng(7).normal(scale=scale, size=tuple(moments[k].shape)))))
        sides.append((params, states))
    names = sorted(groups)
    for step in range(2):
        grads = _grads(groups, alive, rng)
        rows = None
        if scalars == "rows":
            table = torch.tensor([adam_scalars(optimizers[g], sides[0][1][g].count) for g in names])
            rows = {g: table[j] for j, g in enumerate(names)}
        apply_group_updates(optimizers, sides[0][1], sides[0][0], grads, rows, alive=alive, masked=GAUSSIAN_GROUPS)
        _former_update(optimizers, sides[1][1], sides[1][0], grads, alive, rows)
    (p_new, s_new), (p_old, s_old) = sides
    for g in names:
        assert s_new[g].count == s_old[g].count == 7
        for k in groups[g]:
            for a, b in ((p_new[g][k], p_old[g][k]), (s_new[g].mu[k], s_old[g].mu[k]), (s_new[g].nu[k], s_old[g].nu[k])):
                assert torch.equal(_bits(a), _bits(b)), (g, k)
            assert torch.isfinite(p_new[g][k]).all(), (g, k)


def test_adam_update_with_alive_equals_the_masked_update():
    """The sharded step's route: one Gaussian group, its dead rows' NaN
    gradients dropped."""
    rng = np.random.default_rng(3)
    alive = _alive(rng)
    opts = {"features_rest": make_optimizers(OptimizersConfig())["features_rest"]}
    p0 = torch.tensor(rng.normal(size=(N, 45)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(N, 45)), dtype=torch.float32)
    g[~alive] = float("nan")
    sides = []
    for _ in range(2):
        params = {"features_rest": {"features_rest": p0.clone()}}
        sides.append((params, init_opt_states(opts, params)))
    adam_update(opts["features_rest"], sides[0][1]["features_rest"], sides[0][0]["features_rest"],
                {"features_rest": g}, alive=alive)
    _former_update(opts, sides[1][1], sides[1][0], {"features_rest": {"features_rest": g}}, alive)
    (p_new, s_new), (p_old, s_old) = sides
    assert torch.isfinite(p_new["features_rest"]["features_rest"]).all() and s_new["features_rest"].count == 1
    assert torch.equal(_bits(p_new["features_rest"]["features_rest"]), _bits(p_old["features_rest"]["features_rest"]))
    assert torch.equal(_bits(s_new["features_rest"].nu["features_rest"]), _bits(s_old["features_rest"].nu["features_rest"]))


@pytest.mark.parametrize("masked", [(), ("features_rest",), ("scales", "features_rest")])
def test_only_the_named_groups_are_masked(masked):
    """`masked` names the groups whose rows are slots: their dead rows'
    gradients count as zeros, every other group takes its gradient whole."""
    rng = np.random.default_rng(11)
    alive = _alive(rng)
    opts = make_optimizers(OptimizersConfig())
    names = ("scales", "features_rest")
    p0 = {k: torch.tensor(rng.normal(size=(N,) + SHAPES[k]), dtype=torch.float32) for k in names}
    grads = {k: {k: torch.tensor(rng.normal(size=(N,) + SHAPES[k]), dtype=torch.float32)} for k in names}
    params = {k: {k: p0[k].clone()} for k in names}
    states = init_opt_states({k: opts[k] for k in names}, params)
    apply_group_updates(opts, states, params, grads, alive=alive, masked=masked)
    for k in names:
        moved = (params[k][k] != p0[k]).reshape(N, -1).any(1)
        assert torch.equal(moved, alive if k in masked else torch.ones(N, dtype=torch.bool)), k


def test_plain_route_launches_nothing():
    launches = adam_cuda.LAUNCHES["adam"]
    opt = make_optimizers(OptimizersConfig())["scales"]
    p = {"scales": torch.ones(4, 3), "other": torch.ones(5)}
    adam_update(opt, init_opt_states({"s": opt}, {"s": p})["s"], p, {"scales": torch.ones(4, 3)})
    assert adam_cuda.LAUNCHES["adam"] == launches and float(p["other"][0]) == 1.0  # no gradient: zeros


@pytest.mark.parametrize("stage,extras", [(1, False), (1, True), (2, False)])
def test_each_training_step_fits_one_launch(stage, extras):
    """The groups of a stage-1 step (with the camera adjustments and the
    bilateral grid, or without) and of a stage-2 step, at the fields' full
    width, take one launch of the kernel."""
    gaussians = {k: torch.empty((2**19,) + s, device="meta") for k, s in SHAPES.items()}
    fields = (DeformField(), None) if stage == 1 else (None, ControlField())
    adjust = dict(camera_opt=torch.empty(36, 6, device="meta"), bilagrid=torch.empty(36, 16, 16, 8, 12, device="meta"))
    groups = params_by_group(gaussians, *fields, **(adjust if extras else {}))
    numels = [p.numel() for ps in groups.values() for p in ps.values()]
    group_of = [gi for gi, ps in enumerate(groups.values()) for _ in ps]
    assert len(adam_cuda.launch_plan(numels, group_of)) == 1


# ---------------------------------------------------------------------------
# the launch plan and the kernel's table
# ---------------------------------------------------------------------------


def test_launch_plan_packs_the_table_in_order():
    numels = [N * 3, 0, N * 45, 256, 256 * 128, 1]
    (launch,) = adam_cuda.launch_plan(numels, [0, 1, 2, 3, 3, 3])
    assert launch.tensors == (0, 2, 3, 4, 5) and launch.groups == (0, 2, 3)
    assert launch.chunk_start == (0, 1, 5, 6, 14, 15)  # ceil(n / 4096) items a tensor
    assert adam_cuda.launch_plan([0, 0], [0, 1]) == []


def test_launch_plan_splits_at_the_parameter_limit():
    # the stage tables (6 Gaussian tensors and a field's ~20) fit in one launch
    assert len(adam_cuda.launch_plan([4096] * 30, [0] * 6 + [1] * 24)) == 1
    launches = adam_cuda.launch_plan([4096 * 2] * 50, [0] * 50)
    assert [len(l.tensors) for l in launches] == [adam_cuda.MAX_TENSORS, 50 - adam_cuda.MAX_TENSORS]
    assert [i for l in launches for i in l.tensors] == list(range(50))
    assert launches[1].chunk_start == (0, 2, 4)
    by_groups = adam_cuda.launch_plan([1] * 20, list(range(20)))
    assert [l.groups for l in by_groups] == [tuple(range(16)), tuple(range(16, 20))]
    small = adam_cuda.launch_plan([5, 5, 5, 5, 5], [0, 0, 1, 1, 1], max_tensors=2, max_groups=1)
    assert [l.tensors for l in small] == [(0, 1), (2, 3), (4,)]


def test_row_widths_and_strides():
    widths = [adam_cuda.row_width(torch.empty((N,) + s), N) for s in [(), (3,), (4,), (15, 3), (45,), (1,)]]
    assert widths == [1, 3, 4, 45, 45, 1]
    sh = torch.empty(N, 16, 3)  # the SH coefficients' gradient: dc and rest are slices of it
    strides = [adam_cuda.row_stride(g) for g in (sh[:, 0, :], sh[:, 1:, :], sh[:, 1:, :].reshape(N, 45),
                                                  torch.empty(N, 3), torch.empty(N, 1), torch.empty(2 * N)[::2],
                                                  torch.empty(3, N).t(), sh.transpose(1, 2)[:, :, 1:])]
    assert strides == [48, 48, 48, 0, 0, 2, None, None]


def test_kernel_table_fits_its_parameters_and_rounds_its_constants_as_pytorch():
    assert ctypes.sizeof(adam_cuda._Table) <= 4096
    rng = np.random.default_rng(4)
    alive = _alive(rng)
    t = lambda *s: torch.zeros(s)
    groups = [
        adam_cuda.AdamGroup(0.9, 0.999, 1e-15, (-1e-3, 10.0, 1000.0), [(t(N, 3), t(N, 16, 3)[:, 0, :], t(N, 3), t(N, 3))], True),
        adam_cuda.AdamGroup(0.9, 0.999, 1e-15, torch.ones(3), [(t(256), None, t(256), t(256)), (t(7, 5), t(7, 5), t(7, 5), t(7, 5))]),
    ]
    flat = [(gi, x) for gi, grp in enumerate(groups) for x in grp.tensors]
    (launch,) = adam_cuda.launch_plan([x[0].numel() for _, x in flat], [gi for gi, _ in flat])
    table = adam_cuda._table(groups, flat, launch, alive, N)
    assert table.num_tensors == 3 and list(table.row_width[:3]) == [3, 0, 0] and list(table.group[:3]) == [0, 1, 1]
    assert list(table.g_stride[:3]) == [48, 0, 0]
    assert list(table.numel[:3]) == [N * 3, 256, 35] and list(table.chunk_start[:4]) == [0, 1, 2, 3]
    assert table.g[1] is None and table.g[0] == flat[0][1][1].data_ptr() and table.alive == alive.data_ptr()
    g0, g1 = table.groups[0], table.groups[1]
    # 1 - b1 in double, then rounded: as a Python scalar reaches PyTorch's f32 kernels
    assert g0.c1 == np.float32(1 - 0.9) != np.float32(1) - np.float32(0.9)
    assert g0.c2 == np.float32(1 - 0.999) and g0.eps == np.float32(1e-15) and g0.b1 == np.float32(0.9)
    assert g0.scalars is None and (g0.neg_lr, g0.inv_bc1, g0.inv_bc2) == (np.float32(-1e-3), 10.0, 1000.0)
    assert g1.scalars == groups[1].scalars.data_ptr()


# ---------------------------------------------------------------------------
# the kernel's argument checks
# ---------------------------------------------------------------------------


def _meta_group(p=None, g=None, mu=None, nu=None, masked=True, scalars=(-1.0, 1.0, 1.0)):
    m = lambda: torch.empty((N, 3), device="meta")
    return adam_cuda.AdamGroup(0.9, 0.999, 1e-15, scalars, [(p if p is not None else m(), g if g is not None else m(),
                                                           mu if mu is not None else m(), nu if nu is not None else m())], masked)


@pytest.mark.parametrize("case", ["noncontiguous", "noncontiguous_p", "noncontiguous_field", "bf16", "f64_moment", "shape",
                                  "alive_rows", "alive_dtype", "no_alive", "scalars_shape", "device"])
def test_table_checks_raise(case):
    alive = torch.empty(N, dtype=torch.bool, device="meta")
    meta = lambda *s, **kw: torch.empty(s, device="meta", **kw)
    group = {
        "noncontiguous": lambda: _meta_group(g=meta(3, N).t()),
        "noncontiguous_p": lambda: _meta_group(p=meta(N, 16, 3)[:, 0, :]),
        "noncontiguous_field": lambda: _meta_group(g=meta(N, 16, 3)[:, 0, :], masked=False),
        "bf16": lambda: _meta_group(g=meta(N, 3, dtype=torch.bfloat16)),
        "f64_moment": lambda: _meta_group(nu=meta(N, 3, dtype=torch.float64)),
        "shape": lambda: _meta_group(mu=meta(N, 4)),
        "alive_rows": lambda: _meta_group(p=meta(N + 1, 3), g=meta(N + 1, 3), mu=meta(N + 1, 3), nu=meta(N + 1, 3)),
        "alive_dtype": lambda: _meta_group(),
        "no_alive": lambda: _meta_group(),
        "scalars_shape": lambda: _meta_group(scalars=meta(4)),
        "device": lambda: _meta_group(g=torch.empty(N, 3)),
    }[case]()
    if case == "alive_dtype":
        alive = torch.empty(N, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="adam"):
        adam_cuda.check_table([group], None if case == "no_alive" else alive)


def test_table_checks_pass_a_sound_table_and_other_devices_raise():
    alive = torch.empty(N, dtype=torch.bool, device="meta")
    unmasked = adam_cuda.AdamGroup(0.9, 0.999, 1e-15, torch.empty(3, device="meta"),
                                   [(torch.empty(7, device="meta"), None, torch.empty(7, device="meta"),
                                     torch.empty(7, device="meta"))])
    rows = _meta_group(g=torch.empty((N, 16, 3), device="meta")[:, 1, :])  # a slice of the SH gradient
    assert adam_cuda.check_table([_meta_group(), unmasked, rows], alive) == torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        adam_cuda.adam_step([_meta_group()], alive)
