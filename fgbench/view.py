"""The viewer cells: the `viewer` verb's stage-1 route (the trainer over the
dataset, the seeded scene at the served step, `Trainer.start_viewer` on
127.0.0.1 at an ephemeral port) under one closed-loop client that asks for
the next frame when the last one has arrived, as the viewer page does.

The client walks a drag path of views (`path_views` views: th around the
scene, ph and r swinging, t sweeping [0, 1]); the seed picks where on the
path a run starts and which way it goes, so every seed asks for the same
views. Each request is timed from its send to its last JPEG byte; a non-200
reply or a timeout fails it. After the window a sample of the served frames
drawn from the seed (the slowest among them) is held against the reference:
its frame at the same view, quantized as the viewer quantizes and encoded
as the viewer encodes (Pillow's JPEG defaults), decoded beside the served
JPEG.
"""

from __future__ import annotations

import gc
import http.client
import io
import math
import shutil
import time
from typing import List

import numpy as np
import torch

import train
from reference import stage1

SERVE_BACKGROUND = (0.1490, 0.1647, 0.2157)  # the serving background of "random" (models/splat_model.py)


def drag_path(n: int, radius) -> List[tuple]:
    """(th, ph, r, t) of n views along a drag around the scene."""
    r0, r1 = radius
    out = []
    for i in range(n):
        u = i / n
        out.append((2.0 * math.pi * u, 0.5 * math.sin(6.0 * math.pi * u), r0 + (r1 - r0) * (0.5 + 0.5 * math.cos(4.0 * math.pi * u)),
                    abs(2.0 * (u * 3.0 % 1.0) - 1.0)))
    return out


def order_of(n: int, seed: int) -> List[int]:
    rng = np.random.default_rng(seed)
    start, step = int(rng.integers(n)), (1 if rng.integers(2) else -1)
    return [(start + step * k) % n for k in range(n)]


def query(view) -> str:
    th, ph, r, t = view
    return f"/render?th={th:.6f}&ph={ph:.6f}&r={r:.6f}&t={t:.6f}"


def get(port: int, path: str, timeout: float = 10.0):
    """(status, body, seconds from send to the last byte)."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        status = resp.status
    except (OSError, http.client.HTTPException):
        status, body = 0, b""
    finally:
        conn.close()
    return status, body, time.perf_counter() - t0


def orbit_c2w(th: float, ph: float, r: float) -> np.ndarray:
    """The viewer's look-at-origin camera (`viewer/server.py:orbit_camera`,
    frozen copy): OpenGL c2w, +y up."""
    eye = r * np.array([math.cos(ph) * math.sin(th), math.sin(ph), math.cos(ph) * math.cos(th)], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0, 1, 0], np.float32))
    right = right / max(np.linalg.norm(right), 1e-8)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w[:3]


def reference_jpeg(inputs, view, width: int, height: int, fx: float, dev, quant=None) -> np.ndarray:
    """The reference's frame of a view, through uint8 and a JPEG round trip
    (`quant`: the lower-precision control's rounding of the field)."""
    from PIL import Image

    th, ph, r, t = view
    frame = {"c2w": orbit_c2w(th, ph, r), "fx": fx, "fy": fx, "cx": width / 2.0, "cy": height / 2.0,
             "width": width, "height": height, "time": t}
    bg = torch.tensor(SERVE_BACKGROUND, device=dev)
    rgb = stage1.render(inputs.truth, inputs.deform, frame, bg, quant=quant).cpu().numpy()
    rgb8 = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb8).save(buf, "JPEG")
    return decode(buf.getvalue())


def decode(body: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"), dtype=np.int16)


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, t_process: float,
        device="cuda", keep: bool = False) -> dict:
    """One run of the cell; `keep` also returns the inputs and the served
    frames (for the calibration's control)."""
    dev = torch.device(device)
    work = train.scratch_dir()
    server = None
    try:
        inputs, trainer = train.prepare(cfg, traffic, seed, dev, work)
        with torch.no_grad():  # the served scene is the seeded one, unperturbed
            for k, v in trainer.state.params.items():
                v[: inputs.n].copy_(inputs.truth[k])
        w, h = traffic["width"], traffic["height"]
        server = trainer.start_viewer(port=0, width=w, height=h, host="127.0.0.1")
        path = drag_path(traffic["path_views"], traffic["radius"])
        order = order_of(len(path), seed)
        for k in range(traffic["warm_requests"]):  # the first builds the kernels in a fresh checkout
            status, _, _ = get(server.port, query(path[order[k % len(order)]]), timeout=1200.0)
            if status != 200:
                raise RuntimeError(f"warm-up request failed with status {status}")
        _sync(dev)
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_process

        served, lat, failed, k = [], [], 0, 0
        render_s = []
        tw = None
        if trace:
            import tracing

            inner = server.render_fn

            def timed(camera, atrb_values=None):
                _sync(dev)
                t0 = time.perf_counter()
                out = inner(camera, atrb_values)
                _sync(dev)
                render_s.append(time.perf_counter() - t0)
                return out

            server.render_fn = timed
            tw = tracing.Window(dev).__enter__()
        while True:
            view = path[order[k % len(order)]]
            status, body, s = get(server.port, query(view))
            lat.append(s)
            if status == 200:
                served.append((k, view, body, s))
            else:
                failed += 1
            k += 1
            if trace and k >= traffic["trace_requests"]:
                break
            if not trace and time.perf_counter() - t_w0 >= seconds:
                break
        window_s = time.perf_counter() - t_w0
        trace_data = None
        if tw is not None:
            tw.__exit__(None, None, None)
            window_s = tw.window_s
            trace_data = tw.result()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        server.shutdown()
        server = None
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        verdict = compare(inputs, served, traffic, seed, w, h, dev, traffic["limits"])
        ms = np.array(lat) * 1e3
        result = {
            "attempted": len(lat), "failed": failed, "setup_s": setup_s, "window_s": window_s,
            "view_p50_ms": float(np.percentile(ms, 50)), "view_p95_ms": float(np.percentile(ms, 95)),
            "memory_peak_bytes": int(peak), "verdict": verdict, "steps": len(lat),
        }
        q = np.percentile(ms, [10, 50, 90]) if ms.size else [float("nan")] * 3
        print(f"window: {len(lat)} requests in {window_s:.3f} s, {failed} failed; views {w}x{h}; ms p10 {q[0]:.3f}, "
              f"p50 {q[1]:.3f}, p90 {q[2]:.3f}, first third {ms[: ms.size // 3].mean():.3f}, last third "
              f"{ms[-(ms.size // 3 or 1):].mean():.3f}", flush=True)
        if keep:
            result.update(inputs=inputs, served=served)
        if trace:
            result["trace"] = trace_data
            result["render_ms"] = float(np.mean(render_s)) * 1e3 if render_s else None
            result["request_ms"] = float(np.mean(ms))
        return result
    finally:
        if server is not None:
            server.shutdown()
        shutil.rmtree(work, ignore_errors=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample(served, size: int, seed: int) -> List[int]:
    """The served frames that are compared: the slowest one and `size` - 1
    drawn from the seed."""
    rng = np.random.default_rng(seed + 1)
    slowest = max(range(len(served)), key=lambda i: served[i][3])
    return [slowest] + [int(i) for i in rng.choice(len(served), size=min(size, len(served)) - 1, replace=False)]


def compare(inputs, served, traffic: dict, seed: int, w: int, h: int, dev, limits: dict) -> dict:
    """The widest mean |served - reference| (levels of 255, after both JPEG
    round trips) over `sample`'s frames."""
    if not served:
        return {"correct": False, "numbers": {"jpeg_mad": float("inf")}, "limits": dict(limits)}
    worst = 0.0
    for i in sample(served, traffic["sample"], seed):
        _, view, body, _ = served[i]
        want = reference_jpeg(inputs, view, w, h, traffic["fx"], dev)
        got = decode(body)
        worst = max(worst, float(np.abs(got - want).mean()) if got.shape == want.shape else float("inf"))
    numbers = {"jpeg_mad": worst}
    return {"correct": all(numbers[k] <= limits[k] for k in numbers), "numbers": numbers, "limits": dict(limits)}

