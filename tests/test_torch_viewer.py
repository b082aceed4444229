"""The port's `viewer` verb over the port's own checkpoints, and its JPEG
frames, on the CPU.

A tiny dataset (tests/test_data.py) is trained for two steps by the port's
`train` verb and one by `train-control` (a seeded cluster mask); the `viewer`
verb then serves each directory on 127.0.0.1: stage 1 through a `Trainer`
that loads the `train` verb's checkpoint directory (`--data --load`), stage 2
through a `ControlTrainer` over the stage-1 checkpoint and the mask with the
stage-2 directory loaded (`--stage1-checkpoint --gaussian-mask --load`), as
the JAX package's `viewer` builds them (freegaussian_tpu/cli.py:257-281).
`GET /render` answers `image/jpeg`; its bytes are the JPEG of the frame the
verb's render function gives for the same camera, which is the trainer's
own render (`Trainer._render_rgb`; in stage 2 `render_with_control` at the
request's sliders). The JPEG bytes are imageio's (the JAX viewer's encoder)
for the same uint8 frame. Giving two routes, or none, exits non-zero.
"""

import http.client
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from freegaussian_tpu_torch import cli
from freegaussian_tpu_torch.engine.control_trainer import ControlTrainer
from freegaussian_tpu_torch.engine.trainer import Trainer
from freegaussian_tpu_torch.models.control_model import Controller
from freegaussian_tpu_torch.preprocess.clustering import save_gaussian_mask
from freegaussian_tpu_torch.viewer.server import encode_jpeg, orbit_camera, to_rgb8
from test_data import make_synthetic_dataset
from torch_port_helpers import decode_jpeg

REPO = Path(__file__).resolve().parents[1]
CAPACITY = 128
W, H = 40, 24
TH, PH, R, T = 0.3, 0.1, 4.5, 0.4
SLIDERS = [4.0, -2.0, 1.0, 0.0, 3.0, -3.0]  # two attributes


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _quiet(argv):
    with redirect_stdout(io.StringIO()):
        return cli.main(argv)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two `train` steps and one `train-control` step on the CPU; returns the
    paths and both verbs' trainers."""
    root = tmp_path_factory.mktemp("viewer")
    data = root / "scene"
    make_synthetic_dataset(data, n=6, h=32, w=48)
    over = root / "over.yaml"
    over.write_text(
        f"max_num_iterations: 2\ncapacity: {CAPACITY}\nnum_random: 60\nsteps_per_log: 1\nsteps_per_save: 0\n"
        f"steps_per_eval_image: 0\nsteps_per_eval_all_images: 0\noutput_dir: {root / 'out'}\nvis: jsonl\n"
        "pipeline:\n  model:\n    warm_up: 0\n    num_downscales: 0\n"
    )
    base, control_base = str(REPO / "configs/sim/base.yaml"), str(REPO / "configs/control/sim/base.yaml")
    stage1 = _quiet(["train", "--data", str(data), "--config", base, "--scene-config", str(over), "--device", "cpu"])
    ckpt1 = root / "out" / "freegaussian" / "checkpoints"
    alive = stage1.state.alive
    mask = torch.zeros((CAPACITY, 2), dtype=torch.bool)
    mask[alive] = torch.from_numpy(np.random.default_rng(3).uniform(size=(int(alive.sum()), 2)) < 0.5)
    mask_path = root / f"gaussian_mask_{int(alive.sum())}x2.npy"
    save_gaussian_mask(mask_path, mask, alive)
    over2 = root / "over2.yaml"
    over2.write_text(over.read_text().replace("max_num_iterations: 2", "max_num_iterations: 1").replace(
        str(root / "out"), str(root / "out2")))
    stage2 = _quiet(["train-control", "--data", str(data), "--config", control_base, "--scene-config", str(over2),
                     "--stage1-checkpoint", str(ckpt1), "--gaussian-mask", str(mask_path), "--device", "cpu"])
    return dict(data=data, base=base, control_base=control_base, over=over, over2=over2, ckpt1=ckpt1,
                ckpt2=root / "out2" / "freegaussian" / "checkpoints", mask=mask_path, stage1=stage1, stage2=stage2)


def _serve_flags():
    return ["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--width", str(W), "--height", str(H)]


def _render_query(atrb=None):
    q = f"/render?th={TH}&ph={PH}&r={R}&t={T}"
    return q if atrb is None else q + "&atrb=" + ",".join(map(str, atrb))


def test_viewer_serves_the_train_verbs_checkpoint(trained):
    args = cli.build_parser().parse_args(
        ["viewer", "--data", str(trained["data"]), "--config", trained["base"], "--scene-config", str(trained["over"]),
         "--load", str(trained["ckpt1"]), *_serve_flags()]
    )
    assert cli.viewer_route(args) == "stage1"
    trainer, server = cli.serve_viewer(args)
    try:
        assert type(trainer) is Trainer and int(trainer.state.step) == 2  # the directory's latest step
        for k, v in trained["stage1"].state.params.items():
            assert torch.equal(trainer.state.params[k], v.detach()), k
        status, _, body = _get(server.port, "/info")
        assert status == 200 and json.loads(body) == {"num_attributes": 0}
        status, ctype, body = _get(server.port, _render_query())
        assert status == 200 and ctype == "image/jpeg"
        cam = orbit_camera(TH, PH, R, width=W, height=H, time=T, device="cpu")
        frame = server.render_fn(cam, None)
        assert torch.equal(frame, trainer._render_rgb(cam))
        assert float(frame.std()) > 0.0
        assert body == encode_jpeg(to_rgb8(frame))
        assert decode_jpeg(body).shape == (H, W, 3)
    finally:
        server.shutdown()


def test_viewer_serves_the_control_verbs_checkpoint(trained):
    args = cli.build_parser().parse_args(
        ["viewer", "--data", str(trained["data"]), "--config", trained["control_base"],
         "--scene-config", str(trained["over2"]), "--stage1-checkpoint", str(trained["ckpt1"]),
         "--gaussian-mask", str(trained["mask"]), "--load", str(trained["ckpt2"]), *_serve_flags()]
    )
    assert cli.viewer_route(args) == "stage2"
    trainer, server = cli.serve_viewer(args)
    try:
        assert isinstance(trainer, ControlTrainer) and int(trainer.state.step) == 1
        want_control = trained["stage2"].state.control.state_dict()
        for k, v in trainer.state.control.state_dict().items():
            assert torch.equal(v, want_control[k]), k
        assert torch.equal(trainer.gaussian_mask, trained["stage2"].gaussian_mask)
        status, _, body = _get(server.port, "/info")
        assert status == 200 and json.loads(body) == {"num_attributes": 2}
        status, ctype, body = _get(server.port, _render_query(SLIDERS))
        assert status == 200 and ctype == "image/jpeg"
        cam = orbit_camera(TH, PH, R, width=W, height=H, time=T, device="cpu")
        sliders = Controller(2)
        for i, v in enumerate(np.reshape(SLIDERS, (2, 3))):
            sliders.set_vector3(i, v)
        frame = server.render_fn(cam, sliders.get_atrb_vals())
        assert torch.equal(frame, trainer.render_with_control(cam, sliders.get_atrb_vals())["rgb"])
        assert body == encode_jpeg(to_rgb8(frame))
        rest = _get(server.port, _render_query())[2]
        assert rest == encode_jpeg(to_rgb8(server.render_fn(cam, None))) and rest != body  # the sliders move it
    finally:
        server.shutdown()


@pytest.mark.parametrize("routes", [
    [],
    ["--data", "{data}", "--checkpoint", "step-000030000.ckpt"],
    ["--data", "{data}", "--stage1-checkpoint", "{ckpt1}", "--checkpoint", "step-000030000.ckpt"],
    ["--load", "{ckpt1}"],
])
def test_viewer_refuses_two_routes_or_none(trained, routes):
    argv = ["viewer"] + [a.format(data=trained["data"], ckpt1=trained["ckpt1"]) for a in routes] + _serve_flags()
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code not in (None, 0) and "viewer" in str(exc.value.code)


@pytest.mark.parametrize("shape", [(48, 64), (480, 640)])
def test_jpeg_bytes_match_imageio(shape):
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(shape[0])
    ramp = np.linspace(0, 200, shape[1], dtype=np.float32)[None, :, None]
    frame = (ramp + rng.integers(0, 56, size=(*shape, 3))).astype(np.uint8)
    buf = io.BytesIO()
    imageio.imwrite(buf, frame, format="jpeg")
    got = encode_jpeg(frame)
    assert got == buf.getvalue()
    back = decode_jpeg(got)
    assert back.shape == frame.shape and abs(float(back.mean()) - float(frame.mean())) < 2.0


def test_jpeg_encode_names_pillow_and_the_package_imports_without_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` now raises ImportError
    with pytest.raises(ImportError, match="Pillow"):
        encode_jpeg(np.zeros((4, 4, 3), np.uint8))
    code = ("import sys; import freegaussian_tpu_torch.cli, freegaussian_tpu_torch.viewer.server; "
            "print('PIL' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, check=True)
    assert out.stdout.strip() == "False"
