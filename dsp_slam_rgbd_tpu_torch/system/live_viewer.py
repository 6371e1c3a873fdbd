"""Live map viewer: the reference Viewer's role on a headless host.

Counterpart of `dsp_slam_rgbd_tpu/system/live_viewer.py`.  The reference
opens a Pangolin window (`src/Viewer.cc:60`); here a background thread
renders the CURRENT map (camera trajectory, points, object centers, top
down) to PNG at a fixed rate and an HTTP server serves it with a page
that reloads itself: point a browser at http://host:port/ during a run.

The render thread reads the system's adopted state (one reference, as
stale as every reader of the map may be) and copies to the host only what
it draws; the SLAM loop is never blocked.  matplotlib is imported only
inside `_render_png`.

Usage::

    viewer = LiveViewer(system, port=8765)
    ...  # tracking loop
    viewer.close()

or `python -m dsp_slam_rgbd_tpu_torch.tools.run_slam ... --live-port 8765`.
"""
from __future__ import annotations

import io
import threading
import traceback

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>dsp-slam-rgbd-tpu live map</title>
<meta http-equiv="refresh" content="2">
<style>body{background:#111;color:#ddd;font-family:monospace;margin:1em}
img{max-width:95vw;border:1px solid #333}</style></head>
<body><h3>dsp-slam-rgbd-tpu &mdash; live map</h3>
<div id="s"></div><img src="/map.png"></body></html>
"""


def _render_png(system) -> bytes:
    """Render the current map to PNG bytes (MapDrawer role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from dsp_slam_rgbd_tpu_torch.system.viz import camera_centers

    st = system.state  # the adopted state, read once
    kv = st.kf_valid.cpu().numpy()
    poses = st.kf_pose.cpu().numpy()[kv]
    pts = st.pt_pos.cpu().numpy()[st.pt_valid.cpu().numpy()]
    ov = st.obj_valid.cpu().numpy()
    obj_c = st.obj_pose.cpu().numpy()[ov][:, :3, 3] if ov.any() else None

    centers = camera_centers(poses)
    fig, ax = plt.subplots(figsize=(7, 7))
    fig.patch.set_facecolor("#111111")
    ax.set_facecolor("#111111")
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=0.4, c="gray", alpha=0.4)
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 2], "-", c="#7fd34f", lw=1.5)
        ax.plot(centers[-1, 0], centers[-1, 2], "o", c="#ff5f56", ms=5)
    if obj_c is not None and len(obj_c):
        ax.scatter(obj_c[:, 0], obj_c[:, 2], marker="s", s=60,
                   facecolors="none", edgecolors="#56b6ff")
    ax.set_aspect("equal")
    for sp in ax.spines.values():
        sp.set_color("#444444")
    ax.tick_params(colors="#888888")
    ax.set_title(
        f"kf={int(kv.sum())}  pts={len(pts)}  "
        f"objs={0 if obj_c is None else len(obj_c)}  "
        f"loops={system.loop_closures}  status={system.tracker.status}",
        color="#dddddd", fontsize=9)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight",
                facecolor=fig.get_facecolor())
    plt.close(fig)
    return buf.getvalue()


class LiveViewer:
    """Serve a live top-down map view over HTTP (Viewer/MapDrawer role)."""

    def __init__(self, system, port: int = 8765, refresh_s: float = 1.5):
        import http.server

        self._system = system
        self._refresh = refresh_s
        self._png = b""
        self._png_lock = threading.Lock()
        self._stop = threading.Event()
        self.last_error = None   # traceback of the last failed render
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.startswith("/map.png"):
                    with viewer._png_lock:
                        body = viewer._png
                    ctype = "image/png"
                else:
                    body, ctype = _PAGE, "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer(("0.0.0.0", port),
                                                      Handler)
        self.port = self._httpd.server_address[1]
        self._render_thread = threading.Thread(target=self._render_loop,
                                               daemon=True,
                                               name="live-viewer-render")
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="live-viewer-http")
        self._render_thread.start()
        self._serve_thread.start()

    def _render_loop(self):
        while not self._stop.is_set():
            try:
                png = _render_png(self._system)
                with self._png_lock:
                    self._png = png
            except Exception:  # the page keeps the last picture; the error is kept
                self.last_error = traceback.format_exc()
            self._stop.wait(self._refresh)

    def close(self):
        self._stop.set()
        self._httpd.shutdown()
        self._render_thread.join(timeout=5.0)
