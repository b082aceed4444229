"""The port's densification and initialization against the JAX package.

`update_stats`, `refine` (with the JAX package's own split-sample normals
handed to the port) and `zero_moment_rows` on the same padded state; the
counts, masks and scattered rows must agree exactly (float rows to f32
rounding: rtol 1e-6; the split samples' means to 4 f32 eps of their
summands, `_assert_means_close`). `init_gaussians` with seed points against the JAX
version (its sklearn KNN against the port's torch.cdist blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models import densify as j_dens
from freegaussian_tpu.models import gaussians as j_gauss
from freegaussian_tpu_torch.engine.optimizers import AdamState
from freegaussian_tpu_torch.models import densify as t_dens
from freegaussian_tpu_torch.models import gaussians as t_gauss
from torch_port_helpers import gaussian_scene_3d

CAP, N = 160, 120


def _state(seed=0):
    """A padded scene with spread scales and opacities, plus seeded
    statistics as after some steps (some Gaussians unseen)."""
    params, alive = gaussian_scene_3d(n=N, seed=seed, capacity=CAP)
    rng = np.random.default_rng(seed + 1)
    params["scales"][:N] = np.log(rng.uniform(0.002, 0.8, size=(N, 3))).astype(np.float32)
    params["scales"][:30] = np.log(rng.uniform(0.002, 0.009, size=(30, 3))).astype(np.float32)  # duplicate-sized
    stats = {
        "xys_grad_norm": (rng.uniform(size=CAP) * 2e-4 * alive).astype(np.float32),
        "vis_counts": (1 + rng.integers(0, 4, size=CAP)).astype(np.float32),
        "max_2dsize": (rng.uniform(0, 0.25, size=CAP) * alive).astype(np.float32),
    }
    return params, alive, stats


def _rotmat64(quats):
    q = quats / np.sqrt((quats * quats).sum(-1, keepdims=True) + 1e-24)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
         2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
         2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1,
    ).reshape(q.shape[:-1] + (3, 3))


def _assert_means_close(params, alive, draws, got, jp):
    """`means` after a refine, row by row. A split sample x = mean + R(quat)
    (exp(scale) * eps) is held, per element, to 4 f32 eps times its
    summands, |mean| + sum_j |exp(scale_j) eps_j| (each entry of R carries
    an absolute error of a few eps whatever its size: the entries are sums
    like 1 - 2 (y^2 + z^2) of a normalized quaternion), against the JAX
    value and against the float64 value of the same formula on the same f32
    inputs. Both packages round it differently: XLA on the CPU normalizes
    the quaternion by a reciprocal square root (0.7-0.8 ulp off), PyTorch by
    a correctly rounded division, and R's cancellation scales that up. Rows
    a refine copies or leaves are bit-equal. Returns the split rows' count."""
    want = np.asarray(jp["means"])
    rest = np.asarray(jp["features_rest"])
    m = params["means"].astype(np.float64)
    rots = _rotmat64(params["quats"].astype(np.float64))
    s = np.exp(params["scales"].astype(np.float64))
    n_split = 0
    for i in range(len(want)):
        src = np.flatnonzero((params["features_rest"] == rest[i]).all(-1) & alive)
        if len(src) != 1 or np.array_equal(want[i], params["means"][src[0]]):
            np.testing.assert_array_equal(got[i], want[i], err_msg=f"means row {i}")
            continue
        n = src[0]
        samples = [(m[n] + rots[n] @ (s[n] * e[n]), np.abs(m[n]) + np.abs(s[n] * e[n]).sum()) for e in draws]
        exact, summands = min(samples, key=lambda c: np.abs(c[0] - want[i]).max())
        atol = 4 * np.finfo(np.float32).eps * summands
        for name, a, b in (("port vs JAX", got[i], want[i]), ("JAX vs float64", want[i], exact),
                           ("port vs float64", got[i], exact)):
            np.testing.assert_array_less(np.abs(a - b), atol, err_msg=f"means row {i} (split sample), {name}")
        n_split += 1
    return n_split


def test_update_stats_matches_jax():
    _, alive, stats = _state(1)
    rng = np.random.default_rng(2)
    radii = (rng.integers(0, 12, size=CAP) * alive).astype(np.int32)
    absgrad = rng.uniform(size=(CAP, 2)).astype(np.float32)
    want = j_dens.update_stats(j_dens.DensifyState(**{k: jnp.asarray(v) for k, v in stats.items()}),
                               jnp.asarray(radii), jnp.asarray(absgrad), (32, 48))
    got = t_dens.update_stats(t_dens.DensifyState(**{k: torch.tensor(v) for k, v in stats.items()}),
                              torch.tensor(radii), torch.tensor(absgrad), (32, 48))
    for k in stats:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize(
    "step",
    [
        700,  # densify: splits, duplicates and culls; more candidates than free slots
        3100,  # post-warmup world- and screen-size culls, the big-sample filter, the opacity reset (3100 % 3000 == 100)
        4500,  # past stop_screen_size_at: no screen-size splits or culls
        16000,  # past stop_split_at: culls only
    ],
)
def test_refine_matches_jax_with_the_same_draws(step):
    params, alive, stats = _state(3)
    cfg_kw = dict(refine_every=100, reset_alpha_every=30, densify_grad_thresh=2e-4)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    eps = tuple(torch.tensor(np.asarray(jax.random.normal(k, (CAP, 3)))) for k in (k1, k2))
    jp, ja, jd, jinfo = j_dens.refine(
        j_dens.DensifyConfig(**cfg_kw), {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        j_dens.DensifyState(**{k: jnp.asarray(v) for k, v in stats.items()}), key, jnp.asarray(step), (32, 48), 10,
    )
    tp, ta, td, tinfo = t_dens.refine(
        t_dens.DensifyConfig(**cfg_kw), {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(alive),
        t_dens.DensifyState(**{k: torch.tensor(v) for k, v in stats.items()}), step, (32, 48), 10, split_eps=eps,
    )
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k in ("num_culled", "num_split", "num_dup", "num_alive"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert bool(tinfo["reset_opacity_moments"]) == bool(jinfo["reset_opacity_moments"])
    np.testing.assert_array_equal(tinfo["moment_zero_mask"].numpy(), np.asarray(jinfo["moment_zero_mask"]))
    for k in params:
        if k != "means":
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    n_split = _assert_means_close(params, alive, (eps[0].numpy(), eps[1].numpy()), tp["means"].numpy(), jp)
    assert (n_split > 0) == (step in (700, 4500))
    for k in stats:
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)))
    assert bool(tinfo["reset_opacity_moments"]) == (step == 3100)
    if step == 700:
        assert int(tinfo["num_split"]) > 0 and int(tinfo["num_dup"]) > 0 and int(tinfo["num_culled"]) > 0
        assert int(tinfo["num_alive"]) == CAP  # more candidates than free slots: the rest dropped


def test_refine_draws_from_the_generator():
    params, alive, stats = _state(4)
    outs = []
    for _ in range(2):
        out = t_dens.refine(
            t_dens.DensifyConfig(densify_grad_thresh=2e-4), {k: torch.tensor(v) for k, v in params.items()},
            torch.tensor(alive), t_dens.DensifyState(**{k: torch.tensor(v) for k, v in stats.items()}),
            700, (32, 48), 10, generator=torch.Generator().manual_seed(3),
        )
        outs.append(out[0]["means"])
    assert torch.equal(outs[0], outs[1])


def test_zero_moment_rows_keeps_the_count():
    rng = np.random.default_rng(5)
    mu, nu = rng.normal(size=(CAP, 3)).astype(np.float32), rng.uniform(size=(CAP, 3)).astype(np.float32)
    mask = rng.uniform(size=CAP) < 0.3
    from freegaussian_tpu.engine.optimizers import make_optimizers, OptimizersConfig

    opt = make_optimizers(OptimizersConfig())["means"]
    jst = opt.init(jnp.zeros((CAP, 3)))
    jst = (jst[0]._replace(count=jnp.asarray(9, jnp.int32), mu=jnp.asarray(mu), nu=jnp.asarray(nu)),) + tuple(jst[1:])
    jout = j_dens.zero_moment_rows(jst, jnp.asarray(mask), jnp.zeros((CAP, 3)))
    tst = AdamState(count=9, mu={"means": torch.tensor(mu)}, nu={"means": torch.tensor(nu)})
    tout = t_dens.zero_moment_rows(tst, torch.tensor(mask), torch.zeros(CAP, 3))
    assert tout.count == int(jout[0].count) == 9
    np.testing.assert_array_equal(tout.mu["means"].numpy(), np.asarray(jout[0].mu))
    np.testing.assert_array_equal(tout.nu["means"].numpy(), np.asarray(jout[0].nu))


def test_init_gaussians_matches_jax_on_seed_points():
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    xyz[10] = xyz[11]  # a duplicate point: its nearest neighbour is at distance 0
    rgb = rng.uniform(0, 255, size=(300, 3)).astype(np.float32)
    jp, ja = j_gauss.init_gaussians(jax.random.PRNGKey(0), 320, seed_points=(xyz, rgb), sh_degree=2)
    tp, ta = t_gauss.init_gaussians(
        320, generator=torch.Generator().manual_seed(0), seed_points=(xyz, rgb), sh_degree=2, device="cpu"
    )
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k in ("means", "scales", "features_dc", "features_rest", "opacities"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    q = tp["quats"][:300]
    torch.testing.assert_close(q.norm(dim=-1), torch.ones(300))
    assert torch.all(tp["quats"][300:] == 0)


def test_init_gaussians_random_cloud_and_knn_blocks():
    p, alive = t_gauss.init_gaussians(
        500, generator=torch.Generator().manual_seed(1), num_random=400, random_scale=4.0, sh_degree=1, device="cpu"
    )
    assert int(alive.sum()) == 400 and p["features_rest"].shape == (500, 9)
    assert p["means"][:400].abs().max() <= 2.0 and (p["features_dc"][:400] >= 0).all()
    pts = torch.randn(257, 3, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(t_gauss.knn_mean_dist(pts, block=64), t_gauss.knn_mean_dist(pts, block=4096))
    want = np.asarray(j_gauss._knn_mean_dist(pts.numpy(), 3))
    np.testing.assert_allclose(t_gauss.knn_mean_dist(pts).numpy(), want, rtol=1e-5)
    with pytest.raises(ValueError, match="capacity"):
        t_gauss.init_gaussians(10, num_random=20, device="cpu")
