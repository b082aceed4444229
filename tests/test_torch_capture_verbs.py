"""The port's verbs on real captures, through `cli.main` on the CPU with no
JAX call in the port: `interflow -> train -> cluster` on a tiny distorted
LiveScene-real capture (JPEG frames, undistorted by the datamanager), and
`train -> cluster` on a tiny CoNeRF capture with polygon annotations, each
on its family's shipped config; and every shipped config of those families
(configs/real, configs/control/real, configs/conerf) gives its parser
arguments it takes, with the JAX package's ParsedDataset wherever the JAX
parser takes them too."""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from freegaussian_tpu.data import dataparsers as j_parsers
from freegaussian_tpu_torch import cli
from freegaussian_tpu_torch.data import dataparsers as t_parsers
from freegaussian_tpu_torch.engine.config import trainer_config_from_yaml
from test_torch_data import _assert_parsed_equal
from torch_port_helpers import make_conerf_capture, make_real_capture

REPO = Path(__file__).resolve().parents[1]
FAMILY_CONFIGS = sorted(
    p.relative_to(REPO).as_posix()
    for fam in ("real", "control/real", "conerf") for p in (REPO / "configs" / fam).glob("*.yaml")
)


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = cli.main([str(a) for a in argv])
    return out, buf.getvalue().strip().splitlines()[-1]


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    return {"real": make_real_capture(root / "real", n=6, h=32, w=48),
            "conerf": make_conerf_capture(root / "conerf", n=6, h=32, w=48, route="polygons")}


@pytest.mark.parametrize("path", FAMILY_CONFIGS)
def test_family_configs_reach_the_parsers(captures, path):
    base = REPO / Path(path).parent / "base.yaml"
    cfg = trainer_config_from_yaml(base, REPO / path if REPO / path != base else None)
    data = captures[cfg.dataparser]
    parsed = t_parsers.PARSERS[cfg.dataparser](data, "train", **cfg.dataparser_kwargs)
    assert len(parsed) > 0
    if "downscale_factor" in cfg.dataparser_kwargs and cfg.dataparser == "conerf":
        # the JAX package's parse_conerf has no downscale_factor argument
        with pytest.raises(TypeError, match="downscale_factor"):
            j_parsers.PARSERS["conerf"](data, "train", **cfg.dataparser_kwargs)
        return
    _assert_parsed_equal(parsed, j_parsers.PARSERS[cfg.dataparser](data, "train", **cfg.dataparser_kwargs))


def _overlay(root: Path, out: Path) -> Path:
    over = root / f"{out.name}.yaml"
    over.write_text(
        f"max_num_iterations: 3\ncapacity: 2048\nnum_random: 500\nsteps_per_log: 1\nsteps_per_save: 0\n"
        f"steps_per_eval_image: 0\nsteps_per_eval_all_images: 0\noutput_dir: {out}\nvis: jsonl\n"
        "pipeline:\n  model:\n    warm_up: 0\n    num_downscales: 0\n"
    )
    return over


def test_real_capture_interflow_train_cluster(captures, tmp_path):
    data = captures["real"]
    n, last = _run(["interflow", "--data", data, "--dataparser", "real", "--interval", "2", "--device", "cpu"])
    assert n == 6 and last == "wrote 6 interflow maps"
    flags = ["--data", data, "--config", REPO / "configs/real/base.yaml", "--scene-config", _overlay(tmp_path, tmp_path / "out"),
             "--device", "cpu"]
    trainer, last = _run(["train", *flags])
    assert np.isfinite(json.loads(last)["loss"]) and trainer.config.dataparser == "real"
    frame = trainer.datamanager.frames[0]
    assert frame.image.shape[:2] == frame.flow.shape[:2] == frame.atrb_mask.shape[:2] == (frame.camera.height, frame.camera.width)
    assert (frame.camera.width, frame.camera.height) != (48, 32)  # undistorted and cropped
    trainer, last = _run(["cluster", *flags, "--load", tmp_path / "out/freegaussian/checkpoints"])
    mask_path = data / f"gaussian_mask_{int(trainer.state.alive.sum())}x2.npy"
    assert last == f"wrote {mask_path} and cluster PLY" and np.load(mask_path).shape[1] == 2


def test_conerf_capture_train_cluster(captures, tmp_path):
    data = captures["conerf"]
    flags = ["--data", data, "--config", REPO / "configs/conerf/base.yaml", "--scene-config",
             _overlay(tmp_path, tmp_path / "out"), "--device", "cpu"]
    trainer, last = _run(["train", *flags])
    assert np.isfinite(json.loads(last)["loss"]) and trainer.config.dataparser_kwargs == {"downscale": 2}
    trainer, last = _run(["cluster", *flags, "--load", tmp_path / "out/freegaussian/checkpoints"])
    mask = np.load(data / f"gaussian_mask_{int(trainer.state.alive.sum())}x2.npy")
    assert mask.shape == (int(trainer.state.alive.sum()), 2) and last.startswith("wrote ")
