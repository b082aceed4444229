"""`correct` on the CPU at a tiny size: a sound run of each kind passes, and
each fault the cells can have, planted in the program under the timed path,
turns it false (a step that leaves its state unchanged; half the image left
out of the loss; a served frame altered where it is made). The import check
runs in a fresh process: a dry run of the harness and the program loads no
module of JAX or of the JAX package."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from helpers import FGBENCH, tiny_cell, tiny_view


@pytest.fixture(autouse=True)
def _tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    torch.set_num_threads(4)


def train_run(name="s1_train_chunk10"):
    import train

    cell, cfg, traffic = tiny_cell(name)
    return train.run(cell, cfg, traffic, 2_200_000_001, 0.05, False, time.perf_counter(), device="cpu")


def test_dry_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "import helpers, train, run\n"
        "cell, cfg, traffic = helpers.tiny_cell('s1_train_chunk10')\n"
        "res = train.run(cell, cfg, traffic, 5, 0.05, False, time.perf_counter(), device='cpu')\n"
        "print(json.dumps({'correct': res['verdict']['correct'], 'forbidden': run.forbidden_modules()}))\n"
    ) % str(FGBENCH / "tests")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["forbidden"] == []
    assert line["correct"] is True


@pytest.mark.parametrize("name", ["s1_train_chunk10", "s2_train_chunk10"])
def test_sound_training_run_is_correct(name):
    res = train_run(name)
    assert res["verdict"]["correct"], res["verdict"]


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from freegaussian_tpu_torch.engine import train_step

    monkeypatch.setattr(train_step, "apply_group_updates", lambda *a, **k: None)
    res = train_run()
    assert not res["verdict"]["correct"]
    assert res["verdict"]["numbers"]["change_median"] > 0.5


def test_half_the_image_left_out_is_not_correct(monkeypatch):
    from freegaussian_tpu_torch.engine import train_step

    loss_fn = train_step.loss_fn

    def half(cfg, outputs, batch, params, alive, **kw):
        rows = batch["image"].shape[0] // 2
        return loss_fn(cfg, {**outputs, "rgb": outputs["rgb"][:rows]}, {**batch, "image": batch["image"][:rows]},
                       params, alive, **kw)

    monkeypatch.setattr(train_step, "loss_fn", half)
    res = train_run()
    assert not res["verdict"]["correct"], res["verdict"]


def view_run():
    import view

    cell, cfg, traffic = tiny_view()
    return view.run(cell, cfg, traffic, 2_200_000_003, 0.5, False, time.perf_counter(), device="cpu")


def test_sound_viewer_run_is_correct():
    res = view_run()
    assert res["failed"] == 0 and res["verdict"]["correct"], res["verdict"]


def test_altered_frame_is_not_correct(monkeypatch):
    from freegaussian_tpu_torch.viewer import server

    to_rgb8 = server.to_rgb8

    def altered(rgb):
        out = to_rgb8(rgb).copy()
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(server, "to_rgb8", altered)
    res = view_run()
    assert not res["verdict"]["correct"], res["verdict"]
