"""The port's shell modules: `utils/profiling.py` against the JAX package's
(tests/test_export_utils.py's expectations, the same table), the
`torch.profiler` trace of `device_trace`, and `ViewerServer.serve_forever`."""

import json
import threading
import time
import urllib.request

import pytest
import torch

from freegaussian_tpu import utils as j_utils
from freegaussian_tpu_torch import utils
from freegaussian_tpu_torch.viewer.server import ViewerServer


@pytest.fixture(autouse=True)
def _empty_tables():
    """The port's totals table is process-wide, and every trainer span adds
    to it: each test here starts from an empty one."""
    utils.profiler_summary(reset=True)
    yield


def _exercise(mod):
    @mod.time_function
    def work():
        return sum(range(1000))

    work()
    work()
    with mod.profile_section("manual"):
        pass
    with mod.profile_section("manual"):
        pass
    with mod.profile_section("once"):
        pass
    return mod.profiler_summary(reset=True)


def test_profiler_table_matches_jax():
    """The JAX test's expectations, and the same table: header, row names
    and call counts (the times differ), and `reset` clears it."""
    got, want = _exercise(utils), _exercise(j_utils)
    assert "work" in got and "manual" in got
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert got_lines[0] == want_lines[0]
    rows = lambda lines: sorted((ln[:48].strip(), ln[48:57].strip()) for ln in lines[1:])
    assert rows(got_lines) == rows(want_lines) == [("_exercise.<locals>.work", "2"), ("manual", "2"), ("once", "1")]
    assert [len(ln) for ln in got_lines] == [len(ln) for ln in want_lines]
    assert utils.profiler_summary() == want_lines[0] == j_utils.profiler_summary()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with utils.device_trace(tmp_path / "trace", device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trace would run")
    with pytest.raises(RuntimeError, match="cuda"):
        with utils.device_trace(tmp_path / "trace"):
            pass
    assert not (tmp_path / "trace").exists()


def test_serve_forever_answers_and_stops(capsys):
    server = ViewerServer(lambda camera, atrb=None: torch.zeros(2, 2, 3), port=0, host="127.0.0.1", device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    deadline = time.time() + 10
    while server._httpd is None or server.port == 0:
        assert time.time() < deadline, "the server did not bind"
        time.sleep(0.01)
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=10) as r:
        assert r.status == 200 and b"viewer" in r.read()
    server.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert f"viewer at http://localhost:{server.port}" in capsys.readouterr().out
