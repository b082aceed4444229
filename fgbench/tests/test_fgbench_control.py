"""The lower-precision control, in the program's place at each cell's own
size, comes out not correct under the cell's limits (the reference with
every field product operand rounded through float8 e4m3 and TF32 on).
Needs the card: run on the chip with `pytest fgbench/tests -m cuda`."""

import pytest
import torch

from helpers import bench, view_parts


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA device; this machine has none")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["s1_train_chunk10", "s2_train_chunk10"])
def test_training_control_is_not_correct(name, tmp_path, monkeypatch):
    _need_card()
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import calibrate
    import run

    _, cfg, traffic = run.cell_parts(bench(), name)
    line = calibrate.readings(cfg, traffic, 2_300_000_001, torch.device("cuda"), True)
    limits = traffic["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
    assert any(line["half_batch"][k] > v for k, v in limits.items()), line


@pytest.mark.cuda
def test_viewer_control_is_not_correct(tmp_path, monkeypatch):
    _need_card()
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import calibrate

    cell, cfg, traffic = view_parts()
    line = calibrate.view_readings(cell, cfg, traffic, 2_300_000_002, torch.device("cuda"), True)
    limit = traffic["limits"]["jpeg_mad"]
    assert line["program"]["jpeg_mad"] <= limit < line["control"]["jpeg_mad"], line
