"""Interactive viewer: orbit camera + articulation sliders over HTTP.

Twin of `freegaussian_tpu/viewer/server.py`: the same routes (`/`, `/info`,
`/render?th=&ph=&r=&t=&atrb=`) and page, a stdlib ThreadingHTTPServer, and
one render at a time. Frames are JPEG, encoded by Pillow with the bytes
imageio writes (the reference's encoder): Pillow is imported at the first
encode, so importing the package needs no Pillow, and a missing Pillow
raises there.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data.cameras import Camera
from ..models.control_model import Controller

_PAGE = """<!DOCTYPE html>
<html><head><title>freegaussian-tpu viewer</title><style>
body { background:#1a1d24; color:#ddd; font-family:sans-serif; margin:0; display:flex }
#view { flex:1; display:flex; align-items:center; justify-content:center }
img { max-width:100%; image-rendering:auto; cursor:grab }
#panel { width:260px; padding:16px; background:#232733 }
input[type=range] { width:100% }
label { font-size:12px; color:#9aa }
</style></head><body>
<div id="view"><img id="img" src="/render"/></div>
<div id="panel"><h3>freegaussian-tpu</h3><div id="sliders"></div>
<label>azimuth <input type="range" id="th" min="-3.14" max="3.14" step="0.02" value="0"></label>
<label>elevation <input type="range" id="ph" min="-1.4" max="1.4" step="0.02" value="0"></label>
<label>radius <input type="range" id="r" min="0.5" max="12" step="0.1" value="4"></label>
<label>time <input type="range" id="t" min="0" max="1" step="0.01" value="0"></label>
</div>
<script>
const img = document.getElementById('img');
let pending = false, dirty = false;
async function refresh() {
  if (pending) { dirty = true; return; }
  pending = true;
  const vals = [...document.querySelectorAll('#sliders input')].map(s => s.value);
  const q = new URLSearchParams({
    th: th.value, ph: ph.value, r: r.value, t: t.value, atrb: vals.join(',')
  });
  img.src = '/render?' + q + '&_=' + Date.now();
  await new Promise(res => { img.onload = res; img.onerror = res; });
  pending = false;
  if (dirty) { dirty = false; refresh(); }
}
fetch('/info').then(r => r.json()).then(info => {
  const holder = document.getElementById('sliders');
  for (let i = 0; i < info.num_attributes; i++) {
    for (const axis of ['x','y','z']) {
      const l = document.createElement('label');
      l.textContent = `attr ${i} ${axis}`;
      const s = document.createElement('input');
      s.type = 'range'; s.min = -10; s.max = 10; s.step = 0.1; s.value = 0;
      s.oninput = refresh;
      l.appendChild(s); holder.appendChild(l);
    }
  }
});
for (const id of ['th','ph','r','t']) document.getElementById(id).oninput = refresh;
</script></body></html>"""


def orbit_camera(
    theta: float, phi: float, radius: float, *, width: int, height: int,
    fx: float = 300.0, time: float = 0.0, target=(0.0, 0.0, 0.0), device="cuda",
) -> Camera:
    """OpenGL look-at-target camera on a sphere."""
    from ..device import resolve_device

    dev = resolve_device(device)
    target = np.asarray(target, np.float32)
    eye = target + radius * np.array(
        [np.cos(phi) * np.sin(theta), np.sin(phi), np.cos(phi) * np.cos(theta)], np.float32
    )
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0, 1, 0], np.float32)
    right = np.cross(fwd, up)
    right = right / max(np.linalg.norm(right), 1e-8)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -fwd, eye

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return Camera(
        c2w=torch.from_numpy(c2w[:3].copy()).to(dev),
        fx=scalar(fx), fy=scalar(fx), cx=scalar(width / 2.0), cy=scalar(height / 2.0),
        time=scalar(time), width=width, height=height,
    )


def to_rgb8(rgb) -> np.ndarray:
    """(H, W, 3) float rgb in [0, 1] -> uint8, as the viewer quantizes it."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.detach().float().cpu().numpy()
    return np.clip(np.asarray(rgb) * 255, 0, 255).astype(np.uint8)


def encode_jpeg(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> JPEG bytes with Pillow's defaults (quality 75), the
    bytes `imageio.v2.imwrite(buf, rgb8, format="jpeg")` writes."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the viewer encodes its frames as JPEG with Pillow (PIL), which is not installed") from e
    buf = io.BytesIO()
    Image.fromarray(rgb8).save(buf, "JPEG")
    return buf.getvalue()


def render_orbit_view(
    render_fn: Callable[[Camera, Optional[np.ndarray]], object],
    theta: float, phi: float, radius: float,
    *, width: int = 480, height: int = 360, time: float = 0.0,
    atrb_values: Optional[np.ndarray] = None, device="cuda",
) -> bytes:
    """Render one orbit view to JPEG bytes."""
    cam = orbit_camera(theta, phi, radius, width=width, height=height, time=time, device=device)
    return encode_jpeg(to_rgb8(render_fn(cam, atrb_values)))


def model_render_fn(model) -> Callable:
    """render_fn(camera, atrb_values|None) -> (H, W, 3) rgb over a stage-1
    `SplatModel` (stage 1 has no control sliders)."""

    def render_fn(camera, atrb_values=None):
        del atrb_values
        return model(camera)["rgb"]

    return render_fn


def control_render_fn(model) -> Callable:
    """render_fn(camera, atrb_values|None) -> (H, W, 3) rgb over a stage-2
    `ControlModel`: the sliders' (M, 3) attribute values drive its control
    field (zeros when the request has none). Serve it with
    `num_attributes=model.num_attributes`."""

    def render_fn(camera, atrb_values=None):
        return model(camera, atrb_values)["rgb"]

    return render_fn


class ViewerServer:
    """render_fn(camera, atrb_values|None) -> (H, W, 3) float rgb. Cameras are
    made on `device`; `port=0` binds an ephemeral port, read back from
    `.port` once started; `host="127.0.0.1"` serves this machine only."""

    def __init__(
        self,
        render_fn: Callable,
        *,
        num_attributes: int = 0,
        width: int = 480,
        height: int = 360,
        port: int = 7007,
        host: str = "0.0.0.0",
        device="cuda",
    ):
        self.render_fn = render_fn
        self.host = host
        self.num_attributes = num_attributes
        self.width = width
        self.height = height
        self.port = port
        self.device = device
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                elif url.path == "/info":
                    body = json.dumps({"num_attributes": viewer.num_attributes}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif url.path == "/render":
                    q = parse_qs(url.query)

                    def get(k, d):
                        return float(q.get(k, [d])[0])

                    atrb = None
                    if viewer.num_attributes and q.get("atrb", [""])[0]:
                        flat = np.asarray([float(v) for v in q["atrb"][0].split(",")], np.float32)
                        sliders = Controller(viewer.num_attributes)
                        for i, v in enumerate(flat.reshape(viewer.num_attributes, 3)):
                            sliders.set_vector3(i, v)
                        atrb = sliders.get_atrb_vals()
                    with viewer._lock:
                        body = render_orbit_view(
                            viewer.render_fn,
                            get("th", 0.0), get("ph", 0.0), get("r", 4.0),
                            width=viewer.width, height=viewer.height,
                            time=get("t", 0.0), atrb_values=atrb, device=viewer.device,
                        )
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                else:
                    self.send_response(404)
                    body = b"not found"
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def start_background(self):
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self._thread

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
