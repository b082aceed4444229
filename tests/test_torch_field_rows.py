"""The field MLPs at row counts around the kernels' 128-row block: the
saved tensors are padded to a multiple of `mlp_cuda.ROWS` (128, the rows
of a forward and of a data-gradient block), and the port's fused deform field and
control trunk (their plain versions, on the CPU) agree with the JAX
package's Pallas kernels in interpret mode at n = 1, 63, 65, 127 and 129.
Budgets as tests/test_torch_deform_fused.py: outputs max 1e-2 / normwise
5e-3, gradients normwise 3e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.ops.mlp_pallas import fused_control_trunk, fused_deform_full
from freegaussian_tpu_torch.ops import mlp_cuda
from test_torch_deform_fused import BLOCK, OUT_MAX_REL, OUT_NORM_REL, _close, _trunk

ROW_COUNTS = [1, 63, 65, 127, 129]


def _t(a):
    return torch.tensor(np.ascontiguousarray(a), requires_grad=True)


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_padded_rows_are_the_backward_block(n):
    n_pad = mlp_cuda._padded_rows(n)
    assert n_pad % mlp_cuda.ROWS == 0 and n_pad % 64 == 0 and n <= n_pad < n + mlp_cuda.ROWS
    rng = np.random.default_rng(n)
    ws, bs, hws, hbs = _trunk(rng, 93)
    wpack = mlp_cuda.pack_trunk([torch.tensor(w.T.copy()) for w in ws], 93)
    bias = torch.tensor(np.stack(bs))
    x = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
    t_row = torch.tensor(rng.normal(size=30).astype(np.float32))
    hw = torch.tensor(np.concatenate(hws, 1).T.copy())
    hb = torch.tensor(np.concatenate(hbs))
    y, (emb, acts) = mlp_cuda.deform_field_fwd(x, t_row, wpack, bias, hw, hb, 63, True)
    assert y.shape == (n, 13) and emb.shape == (n_pad, 128) and acts.shape == (8, n_pad, 256)
    # the padded rows embed x = 0: the time row and cos(0) lanes, the same for every padded row
    assert torch.equal(emb[n:], emb[n:n + 1].expand(n_pad - n, 128))
    out = mlp_cuda.deform_field_bwd(x, torch.ones(n, 13), wpack, hw, emb, acts, 63)
    assert out[0].shape == (n, 3) and all(torch.isfinite(g).all() for g in out)


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_deform_field_matches_jax_pallas_at_row_counts(n):
    rng = np.random.default_rng(100 + n)
    ws, bs, hws, hbs = _trunk(rng, 93)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.normal(size=(1, 30)).astype(np.float32)
    dy = rng.normal(size=(n, 13)).astype(np.float32)
    J = lambda arrs: [jnp.asarray(a) for a in arrs]
    y, vjp = jax.vjp(
        lambda *a: fused_deform_full(*a, interpret=True, block=BLOCK),
        jnp.asarray(x), jnp.asarray(t), J(ws), J(bs), J(hws), J(hbs),
    )
    gx, gt, gws, gbs, ghws, ghbs = vjp(jnp.asarray(dy))

    xt, tt = _t(x), _t(t[0])
    wt, bt = [_t(w.T) for w in ws], [_t(b) for b in bs]
    hwt, hbt = _t(np.concatenate(hws, 1).T), _t(np.concatenate(hbs))
    yt = mlp_cuda.deform_field(xt, tt, wt, bt, hwt, hbt)
    yt.backward(torch.tensor(dy))
    _close(yt.detach(), y, "y", OUT_MAX_REL, OUT_NORM_REL)
    _close(xt.grad, gx, "dx")
    _close(tt.grad, gt[0], "d t_row")
    for i in range(8):
        _close(wt[i].grad.T, gws[i], f"dW{i}")
        _close(bt[i].grad, gbs[i], f"db{i}")
    _close(hwt.grad.T, np.concatenate([np.asarray(a) for a in ghws], 1), "d head_w")
    _close(hbt.grad, np.concatenate([np.asarray(a) for a in ghbs]), "d head_b")


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_control_trunk_matches_jax_pallas_at_row_counts(n):
    rng = np.random.default_rng(200 + n)
    ws, bs, _, _ = _trunk(rng, 126)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    value = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    dh = rng.normal(size=(n, 256)).astype(np.float32)
    J = lambda arrs: [jnp.asarray(a) for a in arrs]
    h, vjp = jax.vjp(
        lambda *a: fused_control_trunk(*a, interpret=True, block=BLOCK),
        jnp.asarray(x), jnp.asarray(value), J(ws), J(bs),
    )
    gx, gv, gws, gbs = vjp(jnp.asarray(dh))

    xt, vt = _t(x), _t(value)
    wt, bt = [_t(w.T) for w in ws], [_t(b) for b in bs]
    ht = mlp_cuda.field_trunk(xt, vt, None, wt, bt)
    ht.backward(torch.tensor(dh))
    _close(ht.detach(), h, "h", OUT_MAX_REL, OUT_NORM_REL)
    _close(xt.grad, gx, "dx")
    _close(vt.grad, gv, "d value")
    for i in range(8):
        _close(wt[i].grad.T, gws[i], f"dW{i}")
        _close(bt[i].grad, gbs[i], f"db{i}")
