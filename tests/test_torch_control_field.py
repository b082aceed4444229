"""The port's control field and field trunk (`models/fields.py:ControlField`,
`ops/mlp_cuda.py:field_trunk`, the port of the TPU kernel pair
`mlp_pallas.py:_fused_field_fwd` / `_fused_field_bwd`) against the JAX
package, on the same seeded inputs. On the CPU the port runs the kernels'
plain versions.

Tolerances. The f32 control field (the split-linear chain) against the flax
`ControlField.apply` and `control_apply_headsfused`: 1e-5, f32 summation
order only. The field trunk and everything that runs it against the JAX
Pallas pair in interpret mode: the budgets of tests/test_torch_deform_fused.py
(outputs max |diff| / max |JAX| < 1e-2 and normwise < 5e-3; gradients
normwise < 3e-2), for the same reason: both sides round at the same points,
and a bf16 rounding flip where the f32 sums differ in order carries down the
layers, and through a flipped ReLU mask moves single gradient elements by
their full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models.fields import ControlField as JControlField
from freegaussian_tpu.models.fields import control_apply_fused, control_apply_headsfused, deform_apply_fused
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu.models.splat_model import make_deform_field
from freegaussian_tpu.ops.mlp_pallas import fused_control_trunk, fused_deform_trunk
from freegaussian_tpu_torch.models import torch_compat as t_compat
from freegaussian_tpu_torch.models.fields import ControlField, DeformField
from freegaussian_tpu_torch.models.splat_model import SplatConfig as TConfig
from freegaussian_tpu_torch.models.splat_model import make_control_field
from freegaussian_tpu_torch.ops import mlp_cuda
from torch_port_helpers import field_shapes, flax_linear_vars, gaussian_scene_3d

OUT_MAX_REL, OUT_NORM_REL, GRAD_NORM_REL = 1e-2, 5e-3, 3e-2
BLOCK = 128  # Pallas rows per block on the JAX side (interpret mode pads less)


def _close(got, want, name, max_rel=None, norm_rel=GRAD_NORM_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    diff = got - want
    if max_rel is not None:
        assert np.abs(diff).max() <= max_rel * np.abs(want).max(), (name, np.abs(diff).max(), np.abs(want).max())
    assert np.linalg.norm(diff) <= norm_rel * np.linalg.norm(want), (name, np.linalg.norm(diff), np.linalg.norm(want))


def control_vars(seed, head_scale=0.1):
    """ControlField variables in the torch-default init, its three heads
    scaled by `head_scale`."""
    return flax_linear_vars(np.random.default_rng(seed), field_shapes("control"), [1.0] * 8 + [head_scale] * 3)


def port_control(cvars, impl="split"):
    field = ControlField(impl=impl)
    field.load_state_dict(t_compat.control_state_from_flax(jax.tree.map(np.asarray, cvars)), strict=True)
    return field.requires_grad_(True)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)).astype(np.float32), rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)


def test_control_field_f32_matches_flax():
    """Outputs against `ControlField.apply` and `control_apply_headsfused`
    (broadcast (1, 3) value), and the weight gradients of a loss over the
    three outputs."""
    cvars = control_vars(3)
    x, value = _points(200, 4)
    field = port_control(cvars)
    outs = field(torch.tensor(x), torch.tensor(value))
    ref = jax.jit(JControlField().apply)(cvars, jnp.asarray(x), jnp.asarray(value))
    fused_heads = control_apply_headsfused(JControlField(), cvars, jnp.asarray(x), jnp.asarray(value))
    for a, b, c in zip(outs, ref, fused_heads):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(c), rtol=1e-5, atol=1e-5)
    one = field(torch.tensor(x), torch.tensor(value[:1]))
    ref_one = control_apply_headsfused(JControlField(), cvars, jnp.asarray(x), jnp.asarray(value[:1]))
    for a, b in zip(one, ref_one):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    def j_loss(v):
        d, r, s = JControlField().apply(v, jnp.asarray(x), jnp.asarray(value))
        return jnp.sum(jnp.sin(3 * d)) + jnp.sum(r * r) + jnp.sum(s)

    jgrad = t_compat.control_state_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(j_loss))(cvars)))
    d, r, s = outs
    (torch.sin(3 * d).sum() + (r * r).sum() + s.sum()).backward()
    for name, p in field.named_parameters():
        torch.testing.assert_close(p.grad, jgrad[name], rtol=1e-4, atol=1e-5 * float(jgrad[name].abs().max()))


def _trunk(rng, in_ch):
    dims = [in_ch] + [256] * 7
    dims[5] = in_ch + 256
    ws = [(rng.normal(size=(d, 256)) / np.sqrt(d)).astype(np.float32) for d in dims]
    bs = [(rng.normal(size=256) * 0.01).astype(np.float32) for _ in range(8)]
    return ws, bs


@pytest.mark.parametrize("mode", ["control", "deform"])
def test_field_trunk_matches_jax_pallas(mode):
    """`field_trunk` (plain versions) against `fused_control_trunk` (two
    sources, no time row) and `fused_deform_trunk` (one source and a time
    row): the output and every gradient of one vector-Jacobian product, the
    time row's included; 130 rows, not a multiple of the 64-row block."""
    n = 130
    rng = np.random.default_rng(7 if mode == "control" else 8)
    in_ch = 126 if mode == "control" else 93
    ws, bs = _trunk(rng, in_ch)
    x, value = _points(n, 9)
    t = rng.normal(size=(1, 30)).astype(np.float32)
    dh = rng.normal(size=(n, 256)).astype(np.float32)
    second = value if mode == "control" else t
    jfn = fused_control_trunk if mode == "control" else fused_deform_trunk
    J = lambda arrs: [jnp.asarray(a) for a in arrs]

    @jax.jit
    def fwd_bwd(*args):
        h, vjp = jax.vjp(lambda *a: jfn(*a, interpret=True, block=BLOCK), *args)
        return h, vjp(jnp.asarray(dh))

    h, (gx, gsecond, gws, gbs) = fwd_bwd(jnp.asarray(x), jnp.asarray(second), J(ws), J(bs))

    T = lambda a: torch.tensor(np.ascontiguousarray(a), requires_grad=True)
    xt, st = T(x), T(second if mode == "control" else second[0])
    wt, bt = [T(w.T) for w in ws], [T(b) for b in bs]
    before = dict(mlp_cuda.LAUNCHES)
    if mode == "control":
        ht = mlp_cuda.field_trunk(xt, st, None, wt, bt)
    else:
        ht = mlp_cuda.field_trunk(xt, None, st, wt, bt)
    ht.backward(torch.tensor(dh))
    assert mlp_cuda.LAUNCHES == before  # CPU tensors: the plain versions, no launch
    assert ht.shape == (n, 256) and ht.dtype == torch.float32

    _close(ht.detach(), h, "h", OUT_MAX_REL, OUT_NORM_REL)
    _close(xt.grad, gx, "dx")
    _close(st.grad, np.asarray(gsecond).reshape(st.shape), "d value" if mode == "control" else "d t_row")
    for i in range(8):
        _close(wt[i].grad.T, gws[i], f"dW{i}")
        _close(bt[i].grad, gbs[i], f"db{i}")


def test_deform_field_pallas_matches_jax():
    """`DeformField(impl="pallas")` (timenet, the field trunk with the
    timenet row, f32 heads, screw-axis normalization) against
    `deform_apply_fused(impl="pallas")` on a flax bf16 init: outputs, and
    the weight gradients of a loss over all four outputs, the timenet's
    included (its gradient is the trunk's time-row gradient)."""
    params, alive = gaussian_scene_3d(n=120, seed=31)
    field = make_deform_field(JConfig(deform_bf16=True))
    dvars = flax_linear_vars(np.random.default_rng(32), field_shapes("deform"))
    cfg = TConfig(deform_impl="pallas")
    model = t_compat.state_from_jax_arrays(params, alive, jax.tree.map(np.asarray, dvars), cfg=cfg, device="cpu")
    deform = model.deform.requires_grad_(True)
    assert deform.impl == "pallas"
    x = params["means"]
    t = np.full((1, 1), 0.55, np.float32)

    def j_loss(v):
        d, r, s = deform_apply_fused(field, v, jnp.asarray(x), jnp.asarray(t), interpret=True, impl="pallas", block=BLOCK)
        return jnp.sum(jnp.sin(3 * d.w)) + jnp.sum(d.v * d.v) + jnp.sum(d.theta) + jnp.sum(r) + jnp.sum(s * s), (d, r, s)

    (_, (jd, jr, js)), jgrad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(dvars)
    before = dict(mlp_cuda.LAUNCHES)
    td, tr, ts = deform(torch.tensor(x), torch.tensor(t))
    for name, a, b in (("w", td.w, jd.w), ("v", td.v, jd.v), ("theta", td.theta, jd.theta), ("rotation", tr, jr), ("scaling", ts, js)):
        _close(a.detach(), b, name, OUT_MAX_REL, OUT_NORM_REL)
    loss = torch.sin(3 * td.w).sum() + (td.v * td.v).sum() + td.theta.sum() + tr.sum() + (ts * ts).sum()
    loss.backward()
    assert mlp_cuda.LAUNCHES == before
    want = t_compat.deform_state_from_flax(jax.tree.map(np.asarray, jgrad), True)
    for name, p in deform.named_parameters():
        _close(p.grad, want[name], name)
    assert float(deform.timenet[0].weight.grad.abs().max()) > 0


def test_control_field_pallas_matches_jax():
    """`ControlField(impl="pallas")` against `control_apply_fused(impl="pallas")`:
    outputs, and the gradients of the weights and of the positions (the
    control field sees the means themselves in training)."""
    cvars = control_vars(11, head_scale=1.0)
    x, value = _points(150, 12)

    def j_loss(v, xx):
        d, r, s = control_apply_fused(JControlField(), v, xx, jnp.asarray(value), interpret=True, impl="pallas", block=BLOCK)
        return jnp.sum(jnp.sin(3 * d)) + jnp.sum(r * r) + jnp.sum(s), (d, r, s)

    (_, jout), (jgrad, jgx) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(cvars, jnp.asarray(x))
    field = port_control(cvars, impl="pallas")
    xt = torch.tensor(x, requires_grad=True)
    outs = field(xt, torch.tensor(value))
    for name, a, b in zip(("d_xyz", "d_rot", "d_scale"), outs, jout):
        _close(a.detach(), b, name, OUT_MAX_REL, OUT_NORM_REL)
    d, r, s = outs
    (torch.sin(3 * d).sum() + (r * r).sum() + s.sum()).backward()
    want = t_compat.control_state_from_flax(jax.tree.map(np.asarray, jgrad))
    for name, p in field.named_parameters():
        _close(p.grad, want[name], name)
    _close(xt.grad, jgx, "dx")


def test_field_impls_follow_the_jax_dispatch():
    """`make_control_apply`'s dispatch: "pallas" runs the kernel, anything
    else the f32 chain; the deform field's "pallas" needs bf16."""
    assert make_control_field(TConfig(deform_impl="pallas")).impl == "pallas"
    for impl in ("fused", "headsfused", "flax", "xla"):
        assert make_control_field(TConfig(deform_impl=impl)).impl == "split"
    assert make_control_field(TConfig(deform_impl="pallas", deform_bf16=False)).impl == "pallas"
    assert t_compat.make_deform_field(TConfig(deform_impl="pallas")).impl == "pallas"
    assert t_compat.make_deform_field(TConfig(deform_impl="pallas", deform_bf16=False)).impl == "split"
    with pytest.raises(ValueError, match="8x256"):
        ControlField(depth=2, width=32, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        DeformField(impl="xla")
    # per-point times run the trunk on the precomputed embedding (tests/test_torch_trunk.py)
    field = DeformField(compute_dtype=torch.bfloat16, impl="pallas")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in field.parameters():
            p.copy_((torch.rand(p.shape, generator=gen) - 0.5) * 0.1)
    d, r, s = field(torch.randn(4, 3, generator=gen), torch.rand(4, 1, generator=gen))
    assert d.w.shape == (4, 3) and r.shape == (4, 4) and s.shape == (4, 3) and torch.isfinite(d.w).all()


def test_control_field_reset_parameters_is_torch_default():
    """The fresh control field of the stage-1 -> stage-2 cross-load: U(+-1 /
    sqrt(fan_in)), reproducible from the generator's seed."""
    a = ControlField().reset_parameters(torch.Generator().manual_seed(5))
    b = ControlField().reset_parameters(torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        fan_in = a.get_submodule(name.rsplit(".", 1)[0]).weight.shape[1]
        top = float(p.detach().abs().max())
        assert top <= 1 / np.sqrt(fan_in), name
        if p.numel() >= 256:  # a few hundred draws reach near the bound
            assert top > 0.95 / np.sqrt(fan_in), name
