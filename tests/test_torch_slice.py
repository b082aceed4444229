"""The port's stage-1 serving path end to end against the JAX package, and
its shell (viewer, offline rendering, CLI) on the CPU.

`forward(train=False)` is held against the JAX `forward` with
`backend="pallas"` (the Pallas compositor in interpret mode) on identical
weights, handed over either by the weight bridge or through a reference
checkpoint that the JAX package writes. Tolerances: rgb and accumulation
atol 2e-5 (the JAX package's forward budget); expected depth rtol 1e-4
where accumulation > 0.05 (depth / alpha amplifies the alpha budget where
alpha is small). In bf16 deform mode the same budget holds: the port
rounds at the JAX package's rounding points (tests/test_torch_fields.py).
"""

import dataclasses
import functools
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freegaussian_tpu.models import torch_compat as j_compat
from freegaussian_tpu.models.splat_model import SplatConfig as JConfig
from freegaussian_tpu.models.splat_model import forward as j_forward
from freegaussian_tpu.models.splat_model import make_deform_apply, make_deform_field
from freegaussian_tpu_torch import cli
from freegaussian_tpu_torch.models import torch_compat as t_compat
from freegaussian_tpu_torch.models.splat_model import SplatConfig as TConfig
from freegaussian_tpu_torch.models.splat_model import forward as t_forward
from freegaussian_tpu_torch.preprocess.render_offline import render_color_images, render_depth_maps
from freegaussian_tpu_torch.viewer.png import decode_png, encode_png
from freegaussian_tpu_torch.viewer.server import (
    ViewerServer,
    model_render_fn,
    orbit_camera,
    render_orbit_view,
    to_rgb8,
)
from torch_port_helpers import camera_arrays, gaussian_scene_3d, jax_camera, torch_camera

ATOL = 2e-5


def _jax_side(bf16, tile_size, seed=0, n=200, capacity=216):
    params, alive = gaussian_scene_3d(n=n, seed=seed, capacity=capacity)
    jcfg = JConfig(deform_bf16=bf16, tile_size=tile_size, backend="pallas")
    field = make_deform_field(jcfg)
    dvars = field.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, 3)), jnp.zeros((1, 1)))
    return params, alive, jcfg, field, dvars


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_forward_jit(jcfg, field, dvars, params, alive, camera, warmed_up):
    out = j_forward(
        jcfg, params, alive, camera, deform_variables=dvars, deform_apply=make_deform_apply(jcfg, field),
        sh_degree_now=3, warmed_up=warmed_up, train=False,
    )
    return {k: out[k] for k in ("rgb", "accumulation", "depth", "radii")}


def _jax_forward(jcfg, field, dvars, params, alive, arrs, warmed_up=True):
    # jitted: one compile of the whole forward costs a fraction of the eager
    # first call (Pallas interpret mode compiles per op)
    out = _jax_forward_jit(
        jcfg, field, dvars, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        jax_camera(arrs), jnp.asarray(warmed_up),
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _compare(t_out, j_out):
    np.testing.assert_allclose(t_out["rgb"].numpy(), j_out["rgb"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_out["accumulation"].numpy(), j_out["accumulation"], atol=ATOL, rtol=0)
    seen = j_out["accumulation"] > 0.05
    np.testing.assert_allclose(t_out["depth"].numpy()[seen], j_out["depth"][seen], rtol=1e-4, atol=ATOL)
    np.testing.assert_array_equal(t_out["radii"].numpy(), j_out["radii"])
    assert j_out["accumulation"].max() > 0.9 and seen.mean() > 0.2  # the scene fills the frame


@pytest.mark.parametrize(
    "source,bf16,tile_size",
    [("bridge", False, 32), ("bridge", True, 32), ("bridge", False, 16), ("checkpoint", True, 32)],
)
def test_forward_matches_jax(source, bf16, tile_size, tmp_path):
    params, alive, jcfg, field, dvars = _jax_side(bf16, tile_size)
    arrs = camera_arrays(time=0.6)
    # the split-linear field: the twin of the flax path JAX runs off the TPU
    tcfg = TConfig(deform_bf16=bf16, tile_size=tile_size, deform_impl="headsfused")
    if source == "bridge":
        model = t_compat.state_from_jax_arrays(params, alive, jax.tree.map(np.asarray, dvars), cfg=tcfg, device="cpu")
    else:
        # the JAX package writes the reference checkpoint, the port loads it
        path = j_compat.export_reference_checkpoint(
            tmp_path / "step-000030000.ckpt", {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(alive), deform_vars=dvars, step=30000,
        )
        model = t_compat.load_reference_checkpoint(path, capacity=len(alive), cfg=tcfg, device="cpu")
        assert model.step == 30000
    out = t_forward(
        tcfg, model.params, model.alive, torch_camera(arrs), deform=model.deform,
        sh_degree_now=3, warmed_up=True, train=False,
    )
    _compare(out, _jax_forward(jcfg, field, dvars, params, alive, arrs))
    assert out["rgb"].shape == (32, 48, 3) and out["depth"].shape == (32, 48, 1)


def test_forward_warm_up_gate_matches_jax():
    """Before warm-up the canonical Gaussians render as they are."""
    params, alive, jcfg, field, dvars = _jax_side(False, 32, seed=2)
    arrs = camera_arrays(time=0.9)
    tcfg = TConfig(deform_bf16=False, warm_up=3000)
    model = t_compat.state_from_jax_arrays(params, alive, jax.tree.map(np.asarray, dvars), cfg=tcfg, step=10, device="cpu")
    out = model(torch_camera(arrs))  # step 10 < warm_up: the gate is closed
    _compare(out, _jax_forward(jcfg, field, dvars, params, alive, arrs, warmed_up=False))
    warm = model(torch_camera(arrs), warmed_up=True)
    assert not torch.equal(out["rgb"], warm["rgb"])


def test_forward_background_and_depth_backfill():
    params, alive, _, _, dvars = _jax_side(False, 32, n=40, capacity=40)
    for bg, want in (("random", [0.1490, 0.1647, 0.2157]), ("white", [1.0, 1.0, 1.0]), ("black", [0.0, 0.0, 0.0])):
        cfg = TConfig(background_color=bg)
        model = t_compat.state_from_jax_arrays(params, alive, jax.tree.map(np.asarray, dvars), cfg=cfg, device="cpu")
        # a camera looking away from the scene: nothing is seen
        arrs = camera_arrays(eye=(0.0, 0.0, -4.0))
        arrs["c2w"][:, 2] *= -1.0
        arrs["c2w"][:, 0] *= -1.0
        out = model(torch_camera(arrs), warmed_up=False)
        assert float(out["accumulation"].max()) == 0.0
        np.testing.assert_allclose(out["rgb"].numpy(), np.broadcast_to(np.float32(want), out["rgb"].shape), atol=1e-7)
        assert torch.all(out["depth"] == out["depth"].max())


def _cpu_model(tile_size=32):
    params, alive, _, _, dvars = _jax_side(False, tile_size, seed=4, n=150, capacity=150)
    cfg = TConfig(deform_bf16=False, tile_size=tile_size)
    return t_compat.state_from_jax_arrays(params, alive, jax.tree.map(np.asarray, dvars), cfg=cfg, step=30000, device="cpu")


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_viewer_serves_png_of_the_model_render():
    model = _cpu_model()
    server = ViewerServer(model_render_fn(model), width=48, height=32, port=0, host="127.0.0.1", device="cpu")
    server.start_background()
    try:
        assert server.port != 0
        status, ctype, body = _get(server.port, "/info")
        assert status == 200 and ctype == "application/json" and json.loads(body) == {"num_attributes": 0}
        status, ctype, page = _get(server.port, "/")
        assert status == 200 and b"/render" in page
        assert _get(server.port, "/nope")[0] == 404
        status, ctype, body = _get(server.port, "/render?th=0.4&ph=0.2&r=3.5&t=0.3")
        assert status == 200 and ctype == "image/png"
        img = decode_png(body)
        direct = model(orbit_camera(0.4, 0.2, 3.5, width=48, height=32, time=0.3, device="cpu"))["rgb"]
        np.testing.assert_array_equal(img, to_rgb8(direct))
        assert img.std() > 1.0
    finally:
        server.shutdown()


def test_orbit_camera_and_png_round_trip():
    cam = orbit_camera(0.7, 0.3, 5.0, width=64, height=48, device="cpu")
    eye = cam.c2w[:3, 3].numpy()
    np.testing.assert_allclose(np.linalg.norm(eye), 5.0, atol=1e-5)
    np.testing.assert_allclose(-cam.c2w[:3, 2].numpy(), -eye / np.linalg.norm(eye), atol=1e-5)
    rgb8 = np.random.default_rng(0).integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(rgb8)), rgb8)
    data = render_orbit_view(lambda c, a: torch.full((c.height, c.width, 3), 0.5), 0.0, 0.0, 4.0, width=8, height=6, device="cpu")
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and decode_png(data).shape == (6, 8, 3)


def test_render_offline_writes_png_and_depth(tmp_path):
    model = _cpu_model()
    cams = [torch_camera(camera_arrays(time=t)) for t in (0.1, 0.7)]
    n = render_color_images(model.cfg, model.params, model.alive, cams, tmp_path / "rgb", deform=model.deform, names=["a", "b"])
    assert n == 2
    want = t_forward(model.cfg, model.params, model.alive, cams[1], deform=model.deform, sh_degree_now=3, warmed_up=True, render_mode="RGB")
    np.testing.assert_array_equal(decode_png((tmp_path / "rgb" / "b.png").read_bytes()), to_rgb8(want["rgb"]))
    n = render_depth_maps(model.cfg, model.params, model.alive, cams, tmp_path / "depth", dataparser_scale=2.0)
    depth = np.load(tmp_path / "depth" / "00001.npy")
    ref = t_forward(model.cfg, model.params, model.alive, cams[1], sh_degree_now=0, warmed_up=False)["depth"][..., 0]
    assert n == 2 and depth.shape == (32, 48)
    np.testing.assert_allclose(depth, ref.numpy() / 2.0, rtol=1e-6)


def test_cli_viewer_serves_a_reference_checkpoint(tmp_path):
    model = _cpu_model()
    path = t_compat.export_reference_checkpoint(
        tmp_path / "step-000030000.ckpt", model.params, model.alive, deform=model.deform, step=30000
    )
    args = cli.build_parser().parse_args(["viewer", "--checkpoint", str(path), "--port", "0", "--width", "40", "--height", "24", "--device", "cpu"])
    assert (args.width, args.height, args.device) == (40, 24, "cpu")
    loaded, server = cli.start_viewer(path, port=0, width=40, height=24, device="cpu", host="127.0.0.1")
    try:
        assert dataclasses.asdict(loaded.cfg)["tile_size"] == 32 and loaded.step == 30000
        status, ctype, body = _get(server.port, "/render?th=0.1&ph=0.0&r=4&t=0.5")
        assert status == 200 and decode_png(body).shape == (24, 40, 3)
    finally:
        server.shutdown()
