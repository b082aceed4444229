"""The fused deform field (`ops/mlp_cuda.py`, the port of the TPU kernel pair
`mlp_pallas.py:_fused_field_heads_fwd` / `_fused_field_heads_bwd`) against
the JAX package's Pallas pair in interpret mode, on the same seeded inputs.
On the CPU the port runs the kernels' plain versions.

Tolerances: both sides take bf16 product operands with f32 accumulation and
store bf16 activations, so they differ only by the f32 summation order inside
each product; where that flips the bf16 rounding of an activation, the flip
carries down the layers (on the random weights below, 0-38 of 51200
activations a layer differ, each side as far from a float64 emulation as the
other). Outputs: max |diff| / max |JAX| < 1e-2 (the JAX package's
kernel-vs-emulation budget, tests/test_mlp_pallas.py) and normwise < 5e-3
(seen: 2.6e-3, 2e-4). Gradients: normwise < 3e-2. A carried flip can move a
pre-activation near zero across it, and the flipped ReLU mask then passes or
stops that unit's whole gradient in that row, so single elements may differ
by their full size (seen: up to 8.6e-2 of the max on dW4 at the second seed,
normwise 1.9e-2 at worst; 2e-4 to 1e-3 where no mask flips)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models.fields import deform_apply_fused
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu.models.splat_model import make_deform_field
from freegaussian_tpu.ops.mlp_pallas import fused_deform_full
from freegaussian_tpu_torch.models import torch_compat as t_compat
from freegaussian_tpu_torch.models.fields import DeformField
from freegaussian_tpu_torch.models.splat_model import SplatConfig as TConfig
from freegaussian_tpu_torch.ops import mlp_cuda
from torch_port_helpers import gaussian_scene_3d

OUT_MAX_REL, OUT_NORM_REL, GRAD_NORM_REL = 1e-2, 5e-3, 3e-2
# Pallas rows per block on the JAX side: the per-row arithmetic does not
# depend on it, and interpret mode then pads 130 rows to 512, not 2048
BLOCK = 128


def _close(got, want, name, max_rel=None, norm_rel=GRAD_NORM_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    diff = got - want
    if max_rel is not None:
        assert np.abs(diff).max() <= max_rel * np.abs(want).max(), (name, np.abs(diff).max(), np.abs(want).max())
    assert np.linalg.norm(diff) <= norm_rel * np.linalg.norm(want), (name, np.linalg.norm(diff), np.linalg.norm(want))


def _trunk(rng, in_ch):
    dims = [in_ch] + [256] * 7
    dims[5] = in_ch + 256
    ws = [(rng.normal(size=(d, 256)) / np.sqrt(d)).astype(np.float32) for d in dims]
    bs = [(rng.normal(size=256) * 0.01).astype(np.float32) for _ in range(8)]
    hws = [(rng.normal(size=(256, k)) / 16).astype(np.float32) for k in (3, 3, 4, 3)]
    hbs = [(rng.normal(size=k) * 0.01).astype(np.float32) for k in (3, 3, 4, 3)]
    return ws, bs, hws, hbs


@pytest.mark.parametrize("n,t_lanes", [(130, 30), (70, 21)], ids=["timenet", "no-timenet"])
def test_fused_field_matches_jax_pallas(n, t_lanes):
    """Outputs and every gradient (x, the time row, trunk and heads) of one
    vector-Jacobian product, rows not a multiple of the kernels' 128-row block."""
    rng = np.random.default_rng(n)
    ws, bs, hws, hbs = _trunk(rng, 63 + t_lanes)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.normal(size=(1, t_lanes)).astype(np.float32)
    dy = rng.normal(size=(n, 13)).astype(np.float32)
    J = lambda arrs: [jnp.asarray(a) for a in arrs]
    y, vjp = jax.vjp(
        lambda *a: fused_deform_full(*a, interpret=True, block=BLOCK), jnp.asarray(x), jnp.asarray(t), J(ws), J(bs), J(hws), J(hbs)
    )
    gx, gt, gws, gbs, ghws, ghbs = vjp(jnp.asarray(dy))

    T = lambda a: torch.tensor(np.ascontiguousarray(a), requires_grad=True)
    xt, tt = T(x), T(t[0])
    wt, bt = [T(w.T) for w in ws], [T(b) for b in bs]
    hwt, hbt = T(np.concatenate(hws, 1).T), T(np.concatenate(hbs))
    before = dict(mlp_cuda.LAUNCHES)
    yt = mlp_cuda.deform_field(xt, tt, wt, bt, hwt, hbt)
    yt.backward(torch.tensor(dy))
    assert mlp_cuda.LAUNCHES == before  # CPU tensors: the plain versions, no launch

    _close(yt.detach(), y, "y", OUT_MAX_REL, OUT_NORM_REL)
    _close(xt.grad, gx, "dx")
    _close(tt.grad, gt[0], "d t_row")
    for i in range(8):
        _close(wt[i].grad.T, gws[i], f"dW{i}")
        _close(bt[i].grad, gbs[i], f"db{i}")
    _close(hwt.grad.T, np.concatenate([np.asarray(a) for a in ghws], 1), "d head_w")
    _close(hbt.grad, np.concatenate([np.asarray(a) for a in ghbs]), "d head_b")


def test_deform_field_module_fused_matches_jax():
    """The port's `DeformField(impl="fused")` (timenet, fused field, screw-axis
    normalization) against `deform_apply_fused(impl="fused")` on a flax bf16
    init handed over by the weight bridge: outputs, and the weight gradients
    of a loss over all four outputs, timenet included."""
    params, alive = gaussian_scene_3d(n=120, seed=21)
    field = make_deform_field(JConfig(deform_bf16=True))
    dvars = field.init(jax.random.PRNGKey(22), jnp.zeros((1, 3)), jnp.zeros((1, 1)))
    model = t_compat.state_from_jax_arrays(params, alive, jax.tree.map(np.asarray, dvars), cfg=TConfig(), device="cpu")
    deform = model.deform.requires_grad_(True)
    assert deform.impl == "fused" and TConfig().deform_impl == "fused"
    x = params["means"]
    t = np.full((1, 1), 0.45, np.float32)

    def j_loss(v):
        d, r, s = deform_apply_fused(field, v, jnp.asarray(x), jnp.asarray(t), interpret=True, impl="fused", block=BLOCK)
        return jnp.sum(jnp.sin(3 * d.w)) + jnp.sum(d.v * d.v) + jnp.sum(d.theta) + jnp.sum(r) + jnp.sum(s * s), (d, r, s)

    (_, (jd, jr, js)), jgrad = jax.value_and_grad(j_loss, has_aux=True)(dvars)
    td, tr, ts = deform(torch.tensor(x), torch.tensor(t))
    for name, a, b in (("w", td.w, jd.w), ("v", td.v, jd.v), ("theta", td.theta, jd.theta), ("rotation", tr, jr), ("scaling", ts, js)):
        _close(a.detach(), b, name, OUT_MAX_REL, OUT_NORM_REL)
    loss = torch.sin(3 * td.w).sum() + (td.v * td.v).sum() + td.theta.sum() + tr.sum() + (ts * ts).sum()
    loss.backward()
    want = t_compat.deform_state_from_flax(jax.tree.map(np.asarray, jgrad), True)
    for name, p in deform.named_parameters():
        _close(p.grad, want[name], name)


def test_pack_trunk_round_trip():
    rng = np.random.default_rng(3)
    ws = [torch.tensor(w.T.copy()) for w in _trunk(rng, 93)[0]]
    packed = mlp_cuda.pack_trunk(ws, 93)
    assert packed.dtype == torch.bfloat16 and packed.shape == (mlp_cuda.OFFSETS[-1],)
    for a, b in zip(mlp_cuda.unpack_trunk(packed.float(), 93), ws):
        assert torch.equal(a, b.bfloat16().float())


def test_fused_field_takes_only_its_shape():
    with pytest.raises(ValueError, match="8x256 bf16"):
        DeformField(depth=2, width=32, compute_dtype=torch.bfloat16, impl="fused")
    with pytest.raises(ValueError, match="8x256 bf16"):
        DeformField(compute_dtype=torch.float32, impl="fused")
    model = t_compat.SplatModel(TConfig(deform_bf16=False), 4, device="cpu")
    assert model.deform.impl == "split"  # an f32 field runs the split-linear chain
    fused = t_compat.SplatModel(TConfig(), 4, device="cpu").deform.reset_parameters(torch.Generator().manual_seed(0))
    # per-point times run the trunk on the precomputed embedding (tests/test_torch_trunk.py)
    d, r, s = fused(torch.zeros(4, 3), torch.rand(4, 1, generator=torch.Generator().manual_seed(1)))
    assert d.w.shape == (4, 3) and r.shape == (4, 4) and s.shape == (4, 3) and torch.isfinite(r).all()
