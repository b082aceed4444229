"""Seeded numpy scenes shared by the `test_torch_*` files, which hold the
PyTorch port against the JAX package on identical inputs, and a matching
pair of JAX / port training states with the JAX step's random draws."""

import io

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


def bench_like_scene(n=1500, width=96, height=64, seed=0, channels=3):
    """Screen-space Gaussians as the bench frame holds them: means over the
    whole frame, ~1.2-2.5 px standard deviations (a 3-sigma radius of 4-8
    px), bench.py's opacity mixture (50% in [0.55, 0.99], 30% in [0.1,
    0.55], 20% in [0.02, 0.1]). Returns clustered_scene_2d's layout."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform([0, 0], [width, height], size=(n, 2))
    sx, sy = rng.uniform(1.2, 2.5, size=n), rng.uniform(1.2, 2.5, size=n)
    rho = rng.uniform(-0.5, 0.5, size=n)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    conics = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det], axis=-1)
    u = rng.uniform(size=n)
    opacities = np.where(
        u < 0.5, rng.uniform(0.55, 0.99, n), np.where(u < 0.8, rng.uniform(0.1, 0.55, n), rng.uniform(0.02, 0.1, n))
    )
    radii = np.ceil(3.0 * np.maximum(sx, sy)).astype(np.int32)
    f = lambda x: x.astype(np.float32)
    return f(means2d), f(conics), f(rng.uniform(size=(n, channels))), f(opacities), f(rng.uniform(1.0, 6.0, n)), radii


def flax_linear_vars(rng, shapes, scales=None):
    """Flax `TorchLinear_i` variables ({"params": {"TorchLinear_i": {"kernel"
    (in, out), "bias" (out,)}}}) for the (in, out) `shapes`, in the torch
    default init U(+-1/sqrt(in)) drawn with numpy (a flax init jit-compiles
    for seconds), each layer times `scales[i]`."""
    layers = {}
    for i, (fan_in, fan_out) in enumerate(shapes):
        bound = 1.0 / np.sqrt(fan_in) * (1.0 if scales is None else scales[i])
        layers[f"TorchLinear_{i}"] = {
            "kernel": rng.uniform(-bound, bound, size=(fan_in, fan_out)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, size=fan_out).astype(np.float32),
        }
    return {"params": layers}


def field_shapes(kind, depth=8, width=256):
    """(in, out) of each TorchLinear of a flax field, in creation order:
    "control" (ControlField) or "deform" (DeformField, blender timenet)."""
    in_ch = 126 if kind == "control" else 63 + 30
    trunk = [(in_ch, width)] + [(width + in_ch if i == depth // 2 else width, width) for i in range(depth - 1)]
    head_in = width + in_ch if depth // 2 == depth - 1 else width  # the skip feeds the heads
    if kind == "control":
        return trunk + [(head_in, 3), (head_in, 4), (head_in, 3)]
    return [(13, 256), (256, 30)] + trunk + [(head_in, 3), (head_in, 3), (head_in, 4), (head_in, 3)]


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


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8, by Pillow (the viewer's frames)."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def lpips_weights(seed=0):
    """Seeded AlexNet-LPIPS weights in the npz layout both packages read
    (`conv{i}_w` (O, I, Kh, Kw), `conv{i}_b`, `lin{i}`): conv weights
    N(0, 1 / fan_in), biases N(0, 0.05^2), calibration U(0, 0.2). Not a
    quality metric: a fixed network to hold the two LPIPS forwards together."""
    from freegaussian_tpu_torch.models.metrics import ALEX_CONVS

    rng = np.random.default_rng(seed)
    weights, in_ch = {}, 3
    for i, (out_ch, k, _, _) in enumerate(ALEX_CONVS):
        weights[f"conv{i}_w"] = rng.normal(scale=1.0 / np.sqrt(in_ch * k * k), size=(out_ch, in_ch, k, k)).astype(np.float32)
        weights[f"conv{i}_b"] = rng.normal(scale=0.05, size=(out_ch,)).astype(np.float32)
        weights[f"lin{i}"] = rng.uniform(0, 0.2, size=(out_ch,)).astype(np.float32)
        in_ch = out_ch
    return weights


def vote_boundary_rows(params, alive, arrs, deform=None, low=-0.1, high=1.0, min_alpha=0.0):
    """(N,) bool: the live rows whose cluster vote in the frame of camera
    `arrs` sits on a decision boundary, from the JAX package's values (its
    dense oracle): a projected center coordinate within 1e-4 px of a
    rounding boundary (x.5) or of the frame's edge; a depth difference
    within 1e-5 * d_gaussian / alpha of a window edge (alpha the center
    pixel's, at least 1e-6); with `min_alpha`, the center pixel's alpha
    within 1e-5 of it. `deform` is (flax DeformField, its variables)."""
    import jax
    import jax.numpy as jnp

    from freegaussian_tpu.models.fields import apply_se3_deform
    from freegaussian_tpu.ops.rasterize import rasterization

    W, H = arrs["width"], arrs["height"]
    cam = jax_camera(arrs)
    means = jnp.asarray(params["means"])
    if deform is not None:
        field, dvars = deform
        d_xyz, _, _ = field.apply(dvars, means, cam.time.reshape(1, 1))
        means = apply_se3_deform(means, d_xyz)
    render, alpha, info = rasterization(
        means, jnp.asarray(params["quats"]), jnp.exp(jnp.asarray(params["scales"])),
        jax.nn.sigmoid(jnp.asarray(params["opacities"])[..., 0]), jnp.asarray(params["features_dc"]),
        cam.viewmat[None], cam.K[None], W, H, render_mode="ED", sh_degree=None, alive=jnp.asarray(alive),
        backend="reference",
    )
    xy = np.asarray(info.means2d, np.float64)
    d = np.asarray(info.depths, np.float64)
    xi = np.clip(np.round(xy[:, 0]).astype(np.int64), 0, W - 1)
    yi = np.clip(np.round(xy[:, 1]).astype(np.int64), 0, H - 1)
    a_pix = np.maximum(np.asarray(alpha)[0, yi, xi, 0].astype(np.float64), 1e-6)
    diff = np.asarray(render)[0, yi, xi, 0].astype(np.float64) - d
    frac = xy - np.floor(xy)
    near = (np.abs(frac - 0.5) < 1e-4).any(-1)
    near |= (np.abs(xy) < 1e-4).any(-1) | (np.abs(xy - np.array([W, H])) < 1e-4).any(-1)
    tol = 1e-5 * np.abs(d) / a_pix
    near |= (np.abs(diff - low * d) < tol) | (np.abs(diff - high * d) < tol)
    if min_alpha > 0.0:
        near |= np.abs(a_pix - min_alpha) < 1e-5
    return near & np.asarray(alive)


def _write_jpeg(path, img):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(path, "JPEG")


def make_real_capture(root, n=6, h=24, w=32, *, seed=0, distortion=(-0.08, 0.01, 0.0, 0.0, 0.002, -0.001),
                      per_frame=True, downscale=1, num_attributes=2, fg_masks=True, points="ply",
                      depth=True, opticalflow=True):
    """A seeded LiveScene real capture in nerfstudio's layout: JPEG frames
    `images/frame_{i:05d}.jpg`
    on an arc looking at the origin (`images/images_{downscale}/` at
    1/downscale), `transforms.json` with the meta's
    intrinsics and Brown distortion (k1, k2, k3, k4, p1, p2) and, with
    `per_frame`, per-frame overrides on every other frame; `masks/{fid}.npy`
    (H, W, M+1) articulation boxes, `mask_path` PNG foreground masks,
    seed points as `sparse_pc.ply` (`points="ply"`), a colmap model
    (`"bin"` / `"txt"`, with an applied_transform) or none, and
    `depth/{stem}.npy` / `opticalflow/{stem}.npy` for the interflow verb."""
    import json
    import struct
    from pathlib import Path

    from PIL import Image

    root = Path(root)
    rng = np.random.default_rng(seed)
    k1, k2, k3, k4, p1, p2 = distortion
    meta = {"fl_x": 0.9 * w, "fl_y": 0.92 * w, "cx": w / 2 + 0.7, "cy": h / 2 - 0.4,
            "k1": k1, "k2": k2, "k3": k3, "k4": k4, "p1": p1, "p2": p2, "frames": []}
    for i in range(n):
        ang = -0.5 + i / max(n - 1, 1)
        c2w = np.eye(4)
        c2w[:3] = look_at_c2w((3.0 * np.sin(ang), 0.4 + 0.05 * i, 3.0 * np.cos(ang)))
        stem = f"frame_{i:05d}"
        img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        _write_jpeg(root / "images" / f"{stem}.jpg", img)
        if downscale > 1:
            # where both parsers look: beside the frame (`images/images_{d}/`)
            _write_jpeg(root / "images" / f"images_{downscale}" / f"{stem}.jpg", img[::downscale, ::downscale])
        frame = {"file_path": f"images/{stem}.jpg", "transform_matrix": c2w.tolist()}
        if per_frame and i % 2:
            frame.update(fl_x=meta["fl_x"] * 1.05, cx=meta["cx"] - 0.3, k1=k1 * 1.1 if k1 else 0.0)
        if fg_masks:
            fg = np.zeros((h, w), np.uint8)
            fg[:, : w - 2 - i % 3] = 255
            (root / "fg").mkdir(parents=True, exist_ok=True)
            Image.fromarray(fg).save(root / "fg" / f"{stem}.png")
            frame["mask_path"] = f"fg/{stem}.png"
        meta["frames"].append(frame)
        hh, ww = h // downscale, w // downscale
        if num_attributes:
            m = np.zeros((hh, ww, num_attributes + 1), bool)
            for c in range(1, num_attributes + 1):
                y, x = rng.integers(0, hh // 2), rng.integers(0, ww // 2)
                m[y : y + hh // 2, x : x + ww // 2, c] = i % 3 != c
            m[..., 0] = ~m[..., 1:].any(-1)
            (root / "masks").mkdir(parents=True, exist_ok=True)
            np.save(root / "masks" / f"{i:05d}.npy", m)
        if depth:
            d = rng.uniform(2.0, 5.0, size=(hh, ww, 1)).astype(np.float32)
            d[0, 0] = np.inf
            (root / "depth").mkdir(parents=True, exist_ok=True)
            np.save(root / "depth" / f"{stem}.npy", d)
        if opticalflow and i % 3 != 2:  # a frame without optical flow: zero flow
            (root / "opticalflow").mkdir(parents=True, exist_ok=True)
            np.save(root / "opticalflow" / f"{stem}.npy", rng.normal(size=(hh, ww, 2)).astype(np.float32))
    xyz = rng.normal(scale=0.5, size=(40, 3))
    rgb = rng.integers(0, 256, size=(40, 3)).astype(np.uint8)
    if points == "ply":
        from freegaussian_tpu.data.ply import write_ply_points

        write_ply_points(root / "sparse_pc.ply", xyz.astype(np.float32), rgb)
    elif points in ("bin", "txt"):
        sparse = root / "colmap" / "sparse" / "0"
        sparse.mkdir(parents=True)
        meta["applied_transform"] = [[0, 1, 0, 0.1], [1, 0, 0, -0.2], [0, 0, -1, 0.3]]
        if points == "bin":
            with open(sparse / "points3D.bin", "wb") as f:
                f.write(struct.pack("<Q", len(xyz)))
                for k, (p, c) in enumerate(zip(xyz, rgb)):
                    track = rng.integers(0, 9, size=(int(k % 3) + 1, 2))
                    f.write(struct.pack("<Q3d3Bd", k + 1, *p, *c.tolist(), 0.5))
                    f.write(struct.pack("<Q", len(track)) + track.astype("<i4").tobytes())
        else:
            lines = ["# 3D point list", *(f"{k + 1} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r} {c[0]} {c[1]} {c[2]} 0.5 1 2"
                                         for k, (p, c) in enumerate(zip(xyz, rgb)))]
            (sparse / "points3D.txt").write_text("\n".join(lines) + "\n")
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def make_conerf_capture(root, n=5, h=24, w=32, *, seed=0, downscale=2, route="polygons", num_attributes=2,
                        values=True, bbox=True, points=True):
    """A seeded CoNeRF capture: `dataset.json` (train ids every frame but the
    last, val ids the last), `camera/{fid}.json` (OpenCV orientation and
    position, focal, principal point at full resolution), PNG frames
    `rgb/{downscale}x/{fid}.png` at (h, w), `scene.json` (scale, center and,
    with `bbox`, a bbox), `points.ply`, and annotations by `route`:
    "polygons" (`annotations/{fid}.json` on every other frame, in the
    polygons / shapes / points / vertices layouts), "coco"
    (`annotations.coco.json`) or "blender" (`annotations/{fid}_segmentation.npy`);
    `values.yaml` (frame / class / value entries) with `values`."""
    import json
    from pathlib import Path

    import yaml

    root = Path(root)
    rng = np.random.default_rng(seed)
    ids = [f"{i:06d}" for i in range(n)]
    (root / "dataset.json").parent.mkdir(parents=True, exist_ok=True)
    (root / "dataset.json").write_text(json.dumps({"ids": ids, "train_ids": ids[:-1], "val_ids": ids[-1:]}))
    scene = {"scale": 0.6, "center": [0.1, -0.2, 0.05]}
    if bbox:
        scene["bbox"] = [[-1.0, -0.8, -1.2], [1.1, 0.9, 1.3]]
    (root / "scene.json").write_text(json.dumps(scene))
    (root / "camera").mkdir()
    for i, fid in enumerate(ids):
        c2w = look_at_c2w((2.0 * np.sin(0.2 * i), 0.3, 2.0 * np.cos(0.2 * i)))
        R_c2w = c2w[:, :3].copy()
        R_c2w[:, 1:3] *= -1  # OpenGL -> OpenCV axes
        (root / "camera" / f"{fid}.json").write_text(json.dumps({
            "orientation": R_c2w.T.tolist(), "position": c2w[:, 3].tolist(),
            "focal_length": 0.9 * w * downscale, "principal_point": [w * downscale / 2 + 0.6, h * downscale / 2 - 0.3],
        }))
        img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        from PIL import Image

        (root / "rgb" / f"{downscale}x").mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(root / "rgb" / f"{downscale}x" / f"{fid}.png")
    if points:
        from freegaussian_tpu.data.ply import write_ply_points

        write_ply_points(root / "points.ply", rng.normal(size=(30, 3)).astype(np.float32),
                         rng.integers(0, 256, size=(30, 3)).astype(np.uint8))

    def poly(scale=downscale):
        c = rng.uniform([0.2 * w, 0.2 * h], [0.8 * w, 0.8 * h])
        ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
        r = rng.uniform(2, 0.4 * h, 6)
        return (np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1) * scale).round(2).tolist()

    ann = root / "annotations"
    if route == "polygons":
        ann.mkdir()
        layouts = [("polygons", "points"), ("shapes", "points"), ("polygons", "vertices")]
        for i, fid in enumerate(ids[::2]):
            key, pts = layouts[i % len(layouts)]
            attr = "attribute" if key == "polygons" else "label"
            entries = [{attr: a, pts: poly()} for a in range(num_attributes)]
            (ann / f"{fid}.json").write_text(json.dumps({key: entries}))
    elif route == "coco":
        images = [{"id": 10 + i, "file_name": f"{fid}.png"} for i, fid in enumerate(ids)]
        anns = [{"image_id": 10 + i, "category_id": a + 1, "segmentation": [sum(poly(), [])]}
                for i in range(0, n, 2) for a in range(num_attributes)]
        cats = [{"id": a + 1, "name": f"part{a}"} for a in range(num_attributes)]
        (root / "annotations.coco.json").write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    elif route == "blender":
        ann.mkdir()
        for fid in ids[::2]:
            seg = rng.uniform(size=(h, w, num_attributes)) < 0.2
            np.save(ann / f"{fid}_segmentation.npy", seg)
        (ann / "values.json").write_text(json.dumps({fid: [0.5] * num_attributes for fid in ids}))
    if values:
        entries = [{"frame": int(fid), "class": a, "value": float(rng.uniform(-1, 1))}
                   for fid in ids[1::2] for a in range(num_attributes)]
        (root / "values.yaml").write_text(yaml.safe_dump(entries))
    return root
