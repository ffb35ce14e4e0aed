"""Live streaming preview -- the analog of the reference's HighGUI
display loop (video_io.cpp:167-221: show SBS / disparity / interlaced
while streaming, with pause/quit keys).

GPU servers are headless, so the viewer is a tiny stdlib HTTP server
instead of a window: the stream driver publishes its latest frames
(interlaced, disparity, SBS -- any named uint8 image) and a browser
pointed at http://host:port/ shows them refreshing live, with
pause/resume controls covering the reference's 'p' key.  Frames are
encoded as fast PNGs (zlib level 1, dependency-free) only when a client
actually asks, so an unwatched preview costs one array copy per update.

Endpoints:
  /                 HTML page, auto-refreshing all published images
  /frame/<name>     latest PNG snapshot of one image
  /pause, /resume   toggle a flag the driver can poll (video_io.cpp 'p')
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

_PAGE = """<!doctype html><html><head><title>stereo-to-multiview</title>
<style>body{{background:#111;color:#ddd;font-family:monospace}}
img{{max-width:96vw;display:block;margin:8px 0}}</style></head><body>
<h3>stereo-to-multiview live preview &mdash; frame {frame}
 [{state}] <a href="/pause" style="color:#8af">pause</a>
 <a href="/resume" style="color:#8af">resume</a></h3>
{imgs}
<script>setTimeout(()=>location.reload(), {ms});</script>
</body></html>"""


class PreviewServer:
    """Publish named uint8 frames over HTTP for a live view.

    >>> pv = PreviewServer(8080)
    >>> pv.update(interlaced=il, disp_l=normalize_for_display(dl))
    >>> pv.paused      # driver may poll this (reference 'p' key)
    """

    def __init__(self, port: int = 8089, host: str = "127.0.0.1",
                 refresh_ms: int = 250):
        # loopback by default: /pause is unauthenticated and stalls the
        # stream driver, so exposing it beyond the host must be an
        # explicit opt-in (pass host="0.0.0.0"; ADVICE r4)
        self._frames: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._count = 0
        self.paused = False
        self.refresh_ms = refresh_ms
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # quiet
                pass

            def _send(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame/"):
                    name = self.path[len("/frame/"):].split("?")[0]
                    with outer._lock:
                        img = outer._frames.get(name)
                        img = None if img is None else img.copy()
                    if img is None:
                        self._send(404, "text/plain", b"no such frame")
                        return
                    from stereo_to_multiview_tpu_torch.utils.imageio import (
                        png_bytes)
                    self._send(200, "image/png", png_bytes(img, level=1))
                    return
                if self.path.startswith("/pause"):
                    outer.paused = True
                elif self.path.startswith("/resume"):
                    outer.paused = False
                with outer._lock:
                    names = sorted(outer._frames)
                    count = outer._count
                imgs = "\n".join(
                    f'<div>{n}</div><img src="/frame/{n}?v={count}">'
                    for n in names)
                page = _PAGE.format(frame=count, imgs=imgs,
                                    ms=outer.refresh_ms,
                                    state="PAUSED" if outer.paused
                                    else "running")
                self._send(200, "text/html", page.encode())

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def update(self, **frames: Optional[np.ndarray]) -> None:
        """Publish the latest value of each named frame (uint8 arrays;
        None entries are skipped)."""
        with self._lock:
            for name, img in frames.items():
                if img is None:
                    continue
                self._frames[name] = np.asarray(img)
            self._count += 1

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
