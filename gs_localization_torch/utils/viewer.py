"""Lightweight web viewer for trained Gaussian maps.

An HTTP server that renders the map on its device through the port's
``rasterize`` (on the card: the stream layout's K1) and serves JPEG frames
to a page with orbit controls:

    from gs_localization_torch.utils.viewer import serve
    serve(gaussians, height=480, width=640, port=8800)

The server listens on loopback only unless ``host`` says otherwise (pass
``host="0.0.0.0"`` for remote viewers: the endpoint has no authentication).
``port=0`` takes a free port (``httpd.server_address[1]``); with
``block=False`` the server runs on a daemon thread and ``serve`` returns
it (stop it with ``httpd.shutdown()``).
"""

from __future__ import annotations

import io
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!doctype html><html><head><title>gsloc viewer</title><style>
body{margin:0;background:#111;color:#eee;font-family:monospace}
#c{display:block;margin:12px auto;border:1px solid #444}
#hud{position:fixed;top:8px;left:8px}</style></head><body>
<div id=hud>drag: orbit | wheel: dolly | shift-drag: pan</div>
<img id=c width=%WIDTH% height=%HEIGHT%>
<script>
let az=0, el=0, r=4, cx=0, cy=0, cz=3.5, busy=false, dirty=true;
const img=document.getElementById('c');
function refresh(){ if(busy) {dirty=true; return;} busy=true; dirty=false;
 img.src=`/render?az=${az}&el=${el}&r=${r}&cx=${cx}&cy=${cy}&cz=${cz}&t=${Date.now()}`;
 img.onload=()=>{busy=false; if(dirty) refresh();}; img.onerror=img.onload; }
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];e.preventDefault()};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{ if(!drag) return;
 const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
 if(drag[2]){ cx-=dx*0.003*r; cy-=dy*0.003*r; } else { az+=dx*0.01; el+=dy*0.01; }
 drag=[e.clientX,e.clientY,drag[2]]; refresh(); };
img.onwheel=e=>{ r*=Math.exp(e.deltaY*0.001); refresh(); e.preventDefault(); };
refresh();
</script></body></html>"""


def orbit_w2c(az: float, el: float, r: float, cx: float, cy: float,
              cz: float) -> np.ndarray:
    """4x4 float32 w2c of a camera on a sphere of radius ``r`` around
    (cx, cy, cz), at azimuth ``az`` and elevation ``el``, looking at it."""
    ce, se_ = math.cos(el), math.sin(el)
    ca, sa = math.cos(az), math.sin(az)
    center = np.array([cx, cy, cz])
    campos = center + np.array([r * ce * sa, r * se_, -r * ce * ca])
    fwd = center - campos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])     # w2c rotation rows
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ campos
    return w2c


def serve(gaussians, width: int = 640, height: int = 480, port: int = 8800,
          fov: float = 1.1, raster_cfg=None, block: bool = True,
          host: str = "127.0.0.1"):
    """Serve ``/`` (the page) and ``/render?az=&el=&r=&cx=&cy=&cz=`` (a
    JPEG frame). Returns the server (after it stops, when ``block``)."""
    from ..core.camera import Camera
    from ..raster import RasterizerConfig, rasterize

    if raster_cfg is None:
        raster_cfg = RasterizerConfig()
    fx = width / (2.0 * math.tan(fov / 2.0))
    lock = threading.Lock()

    def render_frame(az, el, r, cx, cy, cz) -> np.ndarray:
        cam = Camera.from_numpy(orbit_w2c(az, el, r, cx, cy, cz), fx, fx,
                                width / 2, height / 2, width, height,
                                device=gaussians.device)
        with lock, torch.no_grad():
            img = rasterize(gaussians, cam, raster_cfg).color.cpu().numpy()
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                body = (_PAGE.replace("%WIDTH%", str(width))
                        .replace("%HEIGHT%", str(height))).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body)
                return
            if u.path == "/render":
                q = parse_qs(u.query)

                def arg(k, d):
                    return float(q.get(k, [d])[0])

                from PIL import Image

                img = render_frame(arg("az", 0), arg("el", 0), arg("r", 4),
                                   arg("cx", 0), arg("cy", 0),
                                   arg("cz", 3.5))
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=85)
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.end_headers()
                    self.wfile.write(buf.getvalue())
                except BrokenPipeError:
                    pass
                return
            self.send_response(404)
            self.end_headers()

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"viewer on http://{host}:{httpd.server_address[1]}/")
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
