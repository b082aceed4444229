"""Seeded numpy scenes shared by the `test_torch_*` files, which hold the
PyTorch port against the JAX package on identical inputs, and a matching
pair of JAX / port training states with the JAX step's random draws."""

import numpy as np


def clustered_scene_2d(n=90, width=48, height=32, seed=0, n_clusters=3, channels=3, dense=False):
    """Screen-space Gaussians clustered around a few centers (the pattern of
    tests/test_rasterize_torch_oracle.py:make_clustered_scene): deep overlap
    exercises termination and the binning cut. `dense` pushes opacities to
    0.5-0.999 everywhere. Returns float32 arrays and int32 radii."""
    rng = np.random.default_rng(seed)
    margin = min(8, width // 4, height // 4)
    centers = rng.uniform([margin, margin], [width - margin, height - margin], size=(n_clusters, 2))
    which = rng.integers(0, n_clusters, size=n)
    means2d = centers[which] + rng.normal(scale=4.0, size=(n, 2))
    a = rng.uniform(0.08, 0.7, size=n)
    cc = rng.uniform(0.08, 0.7, size=n)
    b = rng.uniform(-0.6, 0.6, size=n) * np.sqrt(a * cc)
    conics = np.stack([a, b, cc], axis=-1)
    colors = rng.uniform(size=(n, channels))
    if dense:
        opacities = rng.uniform(0.5, 0.999, size=n)
    else:
        opacities = np.where(
            rng.uniform(size=n) < 0.6, rng.uniform(0.5, 0.99, size=n), rng.uniform(0.02, 0.3, size=n)
        )
    depths = rng.uniform(1.0, 6.0, size=n)
    radii = np.full(n, 9, dtype=np.int32)
    radii[::13] = 0
    f = lambda x: x.astype(np.float32)
    return f(means2d), f(conics), f(colors), f(opacities), f(depths), radii


def random_quats(rng, n):
    u, v, w = rng.uniform(size=(3, n))
    return np.stack(
        [
            np.sqrt(1 - u) * np.sin(2 * np.pi * v),
            np.sqrt(1 - u) * np.cos(2 * np.pi * v),
            np.sqrt(u) * np.sin(2 * np.pi * w),
            np.sqrt(u) * np.cos(2 * np.pi * w),
        ],
        axis=-1,
    ).astype(np.float32)


def gaussian_scene_3d(n=200, seed=0, sh_degree=3, capacity=None):
    """Padded stage-1 parameters (JAX layout: flat features_rest) around the
    origin, sized for a camera at distance ~4 and a 48x32 image."""
    rng = np.random.default_rng(seed)
    cap = capacity or n
    k = (sh_degree + 1) ** 2
    params = {
        "means": rng.normal(scale=0.6, size=(n, 3)).astype(np.float32),
        "scales": np.log(rng.uniform(0.03, 0.12, size=(n, 3))).astype(np.float32),
        "quats": random_quats(rng, n),
        "features_dc": rng.normal(scale=0.8, size=(n, 3)).astype(np.float32),
        "features_rest": rng.normal(scale=0.1, size=(n, (k - 1) * 3)).astype(np.float32),
        "opacities": rng.normal(scale=1.5, size=(n, 1)).astype(np.float32),
    }
    params = {name: np.pad(a, [(0, cap - n)] + [(0, 0)] * (a.ndim - 1)) for name, a in params.items()}
    alive = np.arange(cap) < n
    return params, alive


def look_at_c2w(eye, target=(0.0, 0.0, 0.0)):
    """OpenGL camera-to-world (3, 4) looking from eye at target."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0, 1, 0], np.float32))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    return np.concatenate([np.stack([right, up, -fwd], axis=-1), eye[:, None]], axis=-1).astype(np.float32)


def camera_arrays(width=48, height=32, eye=(0.8, 0.5, 4.0), focal=40.0, time=0.3):
    return dict(
        c2w=look_at_c2w(eye), fx=np.float32(focal), fy=np.float32(focal),
        cx=np.float32(width / 2), cy=np.float32(height / 2), time=np.float32(time),
        width=width, height=height,
    )


def jax_camera(arrs):
    import jax.numpy as jnp

    from freegaussian_tpu.data.cameras import Camera

    return Camera(
        c2w=jnp.asarray(arrs["c2w"]), fx=jnp.asarray(arrs["fx"]), fy=jnp.asarray(arrs["fy"]),
        cx=jnp.asarray(arrs["cx"]), cy=jnp.asarray(arrs["cy"]), time=jnp.asarray(arrs["time"]),
        width=arrs["width"], height=arrs["height"],
    )


def torch_camera(arrs, device="cpu"):
    import torch

    from freegaussian_tpu_torch.data.cameras import Camera

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    return Camera(
        c2w=t(arrs["c2w"]), fx=t(arrs["fx"]), fy=t(arrs["fy"]), cx=t(arrs["cx"]), cy=t(arrs["cy"]),
        time=t(arrs["time"]), width=arrs["width"], height=arrs["height"],
    )


def jax_step_draws(key, capacity):
    """The random numbers the JAX train step draws from `key` (its
    background and its two split-sample normals), as the port's `draws`."""
    import jax
    import torch

    _, k_bg, k_refine = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_refine)
    t = lambda a: torch.tensor(np.asarray(a))
    return {
        "background": t(jax.random.uniform(k_bg, (3,))),
        "split_eps": tuple(t(jax.random.normal(k, (capacity, 3))) for k in (k1, k2)),
    }


def train_state_pair(n=150, capacity=180, seed=0, bf16=False, depth=2, width=32, scene=None):
    """A matching (JAX TrainState, port TrainState) pair built from one seed:
    the padded parameters of `gaussian_scene_3d` (or `scene` = (params,
    alive)), a depth x width deform field initialized by flax, the per-group
    optax Adam states, fresh densification statistics. The port's side goes
    through the weight bridge (`train_state_from_jax`) on the CPU.
    Returns (jax_state, port_state, jax_field, jax_optimizers)."""
    import jax
    import jax.numpy as jnp
    import torch

    from freegaussian_tpu.engine.optimizers import OptimizersConfig, init_opt_states, make_optimizers
    from freegaussian_tpu.engine.train_step import GAUSSIAN_GROUPS, TrainState
    from freegaussian_tpu.models.densify import DensifyState
    from freegaussian_tpu.models.fields import DeformField
    from freegaussian_tpu_torch.models.splat_model import SplatConfig as TConfig
    from freegaussian_tpu_torch.models.torch_compat import train_state_from_jax

    params, alive = scene if scene is not None else gaussian_scene_3d(n=n, seed=seed, capacity=capacity)
    field = DeformField(depth=depth, width=width, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    dvars = field.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, 3)), jnp.zeros((1, 1)))
    optimizers = make_optimizers(OptimizersConfig(max_steps=1000))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    groups = {k: jparams[k] for k in GAUSSIAN_GROUPS}
    groups["deform"] = dvars
    jstate = TrainState(
        params=jparams, alive=jnp.asarray(alive), deform_vars=dvars, control_vars=None,
        opt_states=init_opt_states(optimizers, groups), densify=DensifyState.create(len(alive)),
        step=jnp.asarray(0), key=jax.random.PRNGKey(seed + 2),
    )
    tstate = train_state_from_jax(
        params, alive, jax.tree.map(np.asarray, dvars), jax.tree.map(np.asarray, jstate.opt_states),
        {k: np.asarray(getattr(jstate.densify, k)) for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
        step=0, generator=torch.Generator().manual_seed(seed), cfg=TConfig(deform_bf16=bf16, deform_impl="headsfused"), device="cpu",
    )
    return jstate, tstate, field, optimizers
