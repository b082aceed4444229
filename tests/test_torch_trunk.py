"""The trunk on a precomputed embedding (`ops/mlp_cuda.py:fused_trunk`, the
port of the TPU kernel pair `mlp_pallas.py:_pallas_fwd` / `_fused_trunk_bwd`)
against `mlp_pallas.fused_trunk` in interpret mode, and the deform field with
per-point times against `deform_apply_fused` with (N, 1) times. On the CPU
the port runs the kernels' plain versions.

Tolerances, as tests/test_torch_deform_fused.py states them for the same
numerics (bf16 product operands, f32 accumulation, bf16-stored activations):
outputs max |diff| / max |JAX| < 1e-2 and normwise < 5e-3; gradients
normwise < 3e-2 (the two sides sum the skip layer's products in another
order, and a bf16 rounding flip that moves a ReLU mask passes or stops a
unit's whole gradient in its row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models.fields import deform_apply_fused
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu.models.splat_model import make_deform_field
from freegaussian_tpu.ops.mlp_pallas import fused_trunk as j_fused_trunk
from freegaussian_tpu_torch.models import torch_compat as t_compat
from freegaussian_tpu_torch.models.splat_model import SplatConfig as TConfig
from freegaussian_tpu_torch.ops import mlp_cuda
from torch_port_helpers import field_shapes, flax_linear_vars, gaussian_scene_3d

OUT_MAX_REL, OUT_NORM_REL, GRAD_NORM_REL = 1e-2, 5e-3, 3e-2
BLOCK = 64  # Pallas rows per block on the JAX side (interpret mode pads less)


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
    return ws, bs


@pytest.mark.parametrize("n,e2,broadcast", [(130, 30, False), (70, 21, True)], ids=["per-point", "broadcast"])
def test_fused_trunk_matches_jax_pallas(n, e2, broadcast):
    """The output and every gradient of one vector-Jacobian product: x_emb,
    t_emb ((N, E2), or (1, E2) broadcast, whose gradient sums the rows), the
    eight weights and biases; rows not a multiple of the kernels' 128-row block."""
    rng = np.random.default_rng(n)
    ws, bs = _trunk(rng, 63 + e2)
    x_emb = rng.normal(size=(n, 63)).astype(np.float32)
    t_emb = rng.normal(size=(1 if broadcast else n, e2)).astype(np.float32)
    dh = rng.normal(size=(n, 256)).astype(np.float32)
    J = lambda arrs: [jnp.asarray(a) for a in arrs]

    @jax.jit
    def fwd_bwd(*args):
        h, vjp = jax.vjp(lambda *a: j_fused_trunk(*a, interpret=True, block=BLOCK), *args)
        return h, vjp(jnp.asarray(dh))

    h, (gx, gt, gws, gbs) = fwd_bwd(jnp.asarray(x_emb), jnp.asarray(t_emb), J(ws), J(bs))

    T = lambda a: torch.tensor(np.ascontiguousarray(a), requires_grad=True)
    xt, tt = T(x_emb), T(t_emb)
    wt, bt = [T(w.T) for w in ws], [T(b) for b in bs]
    before = dict(mlp_cuda.LAUNCHES)
    ht = mlp_cuda.fused_trunk(xt, tt, wt, bt)
    ht.backward(torch.tensor(dh))
    assert mlp_cuda.LAUNCHES == before  # CPU tensors: the plain versions, no launch
    assert ht.shape == (n, 256) and ht.dtype == torch.float32

    _close(ht.detach(), h, "h", OUT_MAX_REL, OUT_NORM_REL)
    _close(xt.grad, gx, "d x_emb")
    _close(tt.grad, gt, "d t_emb")
    for i in range(8):
        _close(wt[i].grad.T, gws[i], f"dW{i}")
        _close(bt[i].grad, gbs[i], f"db{i}")


def test_trunk_plain_pieces():
    """`trunk_fwd` / `trunk_bwd` on the CPU: the embedding rounds to bf16,
    padded rows are zero, and d emb has exact zeros in the lanes past the
    weights' fan-in."""
    rng = np.random.default_rng(5)
    in_ch = 93
    ws, bs = _trunk(rng, in_ch)
    n = 70
    inp = torch.zeros(n, 128)
    inp[:, :in_ch] = torch.tensor(rng.normal(size=(n, in_ch)).astype(np.float32))
    wpack = mlp_cuda.pack_trunk([torch.tensor(w.T.copy()) for w in ws], in_ch)
    bias = torch.tensor(np.stack(bs))
    h, (emb, acts) = mlp_cuda.trunk_fwd(inp, wpack, bias, True)
    assert emb.shape == (128, 128) and acts.shape == (8, 128, 256)
    assert torch.equal(emb[:n].float(), inp.bfloat16().float()) and not emb[n:].any()
    assert torch.equal(h, acts[-1, :n])
    h2, saved = mlp_cuda.trunk_fwd(inp, wpack, bias, False)
    assert saved is None and torch.equal(h2, h)
    d_emb, dpack, dbias = mlp_cuda.trunk_bwd(torch.tensor(rng.normal(size=(n, 256)).astype(np.float32)), wpack, emb, acts)
    assert d_emb.shape == (n, 128) and dbias.shape == (8, 256) and dpack.shape == (mlp_cuda.OFFSETS[-1],)
    assert not d_emb[:, in_ch:].any() and d_emb[:, :in_ch].abs().max() > 0
    with pytest.raises(ValueError, match="exceeds"):
        mlp_cuda.fused_trunk(torch.zeros(4, 100), torch.zeros(4, 30), [torch.zeros(256, 130)] + [torch.zeros(256, 256)] * 7, [torch.zeros(256)] * 8)


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_deform_field_per_point_times_matches_jax(impl):
    """`DeformField` under "fused" and "pallas" with (N, 1) times (timenet per
    point, the trunk on the precomputed embedding, f32 heads, screw-axis
    normalization) against `deform_apply_fused` with the same (N, 1) times:
    outputs, and the weight gradients of a loss over all four outputs."""
    params, alive = gaussian_scene_3d(n=120, seed=41)
    field = make_deform_field(JConfig(deform_bf16=True))
    dvars = flax_linear_vars(np.random.default_rng(42), field_shapes("deform"))
    model = t_compat.state_from_jax_arrays(
        params, alive, jax.tree.map(np.asarray, dvars), cfg=TConfig(deform_impl=impl), device="cpu"
    )
    deform = model.deform.requires_grad_(True)
    assert deform.impl == impl
    x = params["means"]
    t = np.random.default_rng(43).uniform(size=(len(x), 1)).astype(np.float32)

    def j_loss(v):
        d, r, s = deform_apply_fused(field, v, jnp.asarray(x), jnp.asarray(t), interpret=True, impl=impl, block=BLOCK)
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
