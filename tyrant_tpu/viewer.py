"""Interactive host viewers streaming device framebuffers.

The reference's presentation path is CUDA-GL interop into a GLFW window with
an ImGui overlay (interop.cpp, main.cpp:139-205).  Here the framebuffer
crosses to the host, so the equivalents are:

  * :class:`HttpViewer` — a dependency-free localhost web viewer: streams
    PNG frames to a canvas and feeds WASD/mouse/slider input back into the
    fly camera + DoF/sun parameters (the ImGui overlay analog, including the
    frame-time readout and the reference's sun keys main.cpp:143-151 and DoF
    sliders main.cpp:192-195).
  * :class:`TerminalViewer` — ANSI half-block preview for ssh sessions.

Run: ``python -m tyrant_tpu.viewer --scene dragon.ply`` then open the URL.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np


def _to_png_bytes(img_u8: np.ndarray) -> bytes:
    from .utils.png import encode_png
    return encode_png(img_u8)


_PAGE = """<!doctype html><html><head><title>tyrant_tpu</title><style>
body{margin:0;background:#111;color:#ccc;font:13px monospace;display:flex}
#v{flex:1;display:flex;align-items:center;justify-content:center}
img{max-width:100%%;image-rendering:pixelated}
#hud{width:230px;padding:10px;background:#1a1a1a}
label{display:block;margin-top:8px}
input[type=range]{width:100%%}
</style></head><body>
<div id=v><img id=f></div>
<div id=hud>
 <div id=stats>-</div>
 <canvas id=hist width=210 height=48 style="background:#000;margin-top:6px"></canvas>
 <label>focal distance <input type=range id=fd min=0.1 max=60 step=0.1 value=1></label>
 <label>lens radius <input type=range id=lr min=0 max=1 step=0.01 value=0></label>
 <label>sun azimuth <input type=range id=sx min=0 max=1 step=0.005 value=0.05></label>
 <label>sun height <input type=range id=sy min=0 max=1 step=0.005 value=0.3></label>
 <p>WASD move &middot; drag to look<br>shift = sprint &middot; space/ctrl = up/down</p>
</div>
<script>
const img=document.getElementById('f');const keys={};let drag=null;
onkeydown=e=>keys[e.key.toLowerCase()]=1;onkeyup=e=>keys[e.key.toLowerCase()]=0;
img.onmousedown=e=>{drag=[e.clientX,e.clientY]};
onmouseup=()=>drag=null;
onmousemove=e=>{if(drag){post({look:[e.clientX-drag[0],e.clientY-drag[1]]});drag=[e.clientX,e.clientY]}};
function post(o){fetch('/input',{method:'POST',body:JSON.stringify(o)})}
setInterval(()=>{
 const f=(keys['w']?1:0)-(keys['s']?1:0), s=(keys['d']?1:0)-(keys['a']?1:0),
       v=(keys[' ']?1:0)-(keys['control']?1:0);
 if(f||s||v)post({move:[f,s,v],sprint:keys['shift']?1:0});
},50);
for(const id of['fd','lr','sx','sy'])
 document.getElementById(id).oninput=e=>post({[id]:parseFloat(e.target.value)});
const hist=document.getElementById('hist'),hctx=hist.getContext('2d');
function drawHist(ts){
 hctx.clearRect(0,0,210,48);if(!ts.length)return;
 const mx=Math.max(...ts,1e-6),w=210/Math.max(ts.length,1);
 hctx.fillStyle='#6c6';
 ts.forEach((t,i)=>{const h=44*t/mx;hctx.fillRect(i*w,48-h,Math.max(w-1,1),h)});
 hctx.fillStyle='#888';hctx.font='9px monospace';
 hctx.fillText(mx.toFixed(0)+' ms',2,9)}
async function loop(){
 img.src='/frame.png?'+Date.now();
 const r=await fetch('/stats');const s=await r.json();
 document.getElementById('stats').innerText=s.text;drawHist(s.times);
 setTimeout(loop,100)}
loop();
</script></body></html>"""


class HttpViewer:
    def __init__(self, renderer, camera, port: int = 8760,
                 steps_per_frame: int = 1, preview_scale: int = 1):
        """``preview_scale``: fetch the framebuffer downsampled by this
        factor (device-side strided slice).  The full-res 1080p u8 buffer
        is ~6.2 MB; a 2x preview fetches a quarter of it while the
        full-res accumulation keeps converging on device."""
        self.renderer = renderer
        self.camera = camera
        self.port = port
        self.steps_per_frame = steps_per_frame
        self.preview_scale = max(1, int(preview_scale))
        self._png = b""
        self._stats = "starting"
        self._times: list[float] = []
        self._lock = threading.Lock()
        self._running = False

    def _render_loop(self):
        """Pipelined step/fetch: each iteration dispatches this frame's
        wavefront steps (async under jax dispatch), then fetches the
        PREVIOUS frame's tonemapped buffer — whose data is already final —
        so the device-to-host fetch overlaps the device steps instead of
        serialising after them (the reference's display path is free via
        GL interop, interop.cpp)."""
        from .ops.tonemap import to_uint8
        frame_ms = 0.0
        pending = None  # device u8 image from the previous iteration
        while self._running:
            t0 = time.perf_counter()
            self.renderer.step(self.camera, self.steps_per_frame)
            img_dev = to_uint8(self.renderer.image())  # async on device
            if self.preview_scale > 1:
                s = self.preview_scale
                img_dev = img_dev[::s, ::s]
            if pending is not None:
                img = np.asarray(pending)  # ready buffer: transfer only
                with self._lock:
                    self._png = _to_png_bytes(img)
            pending = img_dev
            img_dev.block_until_ready()
            # dt is the FULL frame time (all steps_per_frame wavefront
            # steps + display fetch) so ms/frame, fps and the histogram all
            # describe displayed frames (dividing by steps_per_frame
            # would overstate the frame rate)
            dt = (time.perf_counter() - t0) * 1e3
            frame_ms = 0.9 * frame_ms + 0.1 * dt if frame_ms else dt
            with self._lock:
                self._times.append(round(dt, 2))
                if len(self._times) > 120:  # reference plots ~a second of
                    self._times.pop(0)      # frames (main.cpp:178-190)
                spf = (f"  ({self.steps_per_frame} steps/frame)"
                       if self.steps_per_frame > 1 else "")
                self._stats = (f"{frame_ms:.1f} ms/frame  "
                               f"{1e3 / max(frame_ms, 1e-6):.1f} fps{spf}\n"
                               f"pos {np.round(self.camera.position, 1)}")

    def serve(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with viewer._lock:
                        png = viewer._png
                    self._send(200, "image/png", png or b"")
                elif self.path.startswith("/stats"):
                    with viewer._lock:
                        s = json.dumps({"text": viewer._stats,
                                        "times": viewer._times})
                    self._send(200, "application/json", s.encode())
                else:
                    self._send(200, "text/html", (_PAGE % ()).encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n))
                except Exception:
                    msg = {}
                cam = viewer.camera
                if "move" in msg:
                    f, s, v = msg["move"]
                    cam.move(forward=f, strafe=s, vertical=v, delta=0.05,
                             sprint=bool(msg.get("sprint")))
                if "look" in msg:
                    dx, dy = msg["look"]
                    cam.look(dx, dy)
                if "fd" in msg:
                    cam.focal_distance = float(msg["fd"])
                if "lr" in msg:
                    cam.lens_radius = float(msg["lr"])
                if "sx" in msg or "sy" in msg:
                    sx, sy = viewer.renderer.sun_position
                    sx = float(msg.get("sx", sx))
                    sy = float(msg.get("sy", sy))
                    viewer.renderer.set_sun((sx, sy))
                self._send(200, "text/plain", b"ok")

        self._running = True
        t = threading.Thread(target=self._render_loop, daemon=True)
        t.start()
        srv = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        print(f"viewer: http://127.0.0.1:{self.port}/")
        try:
            srv.serve_forever()
        finally:
            self._running = False


class TerminalViewer:
    """ANSI half-block progressive preview (no interaction)."""

    def __init__(self, renderer, camera, cols: int = 100):
        self.renderer = renderer
        self.camera = camera
        self.cols = cols

    def show(self, steps: int = 50, refresh_every: int = 10):
        from .ops.tonemap import to_uint8
        done = 0
        while done < steps:
            self.renderer.step(self.camera, refresh_every)
            done += refresh_every
            img = np.asarray(to_uint8(self.renderer.image()))
            print(f"\x1b[H\x1b[2J{self._ansi(img)}\nsteps {done}/{steps}")

    def _ansi(self, img: np.ndarray) -> str:
        h, w, _ = img.shape
        cols = min(self.cols, w)
        rows = max(2, int(cols * h / w / 2) * 2)
        ys = (np.linspace(0, h - 1, rows)).astype(int)
        xs = (np.linspace(0, w - 1, cols)).astype(int)
        small = img[ys][:, xs]
        lines = []
        for r in range(0, rows - 1, 2):
            line = []
            for c in range(cols):
                tr, tg, tb = small[r, c]
                br, bg, bb = small[r + 1, c]
                line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                            f"\x1b[48;2;{br};{bg};{bb}m▀")
            lines.append("".join(line) + "\x1b[0m")
        return "\n".join(lines)


def main(argv=None):
    import argparse

    from .cli import _add_common, _build
    from .render import Renderer

    ap = argparse.ArgumentParser(prog="tyrant_tpu.viewer")
    _add_common(ap)
    ap.add_argument("--port", type=int, default=8760)
    ap.add_argument("--terminal", action="store_true")
    ap.add_argument("--steps-per-frame", type=int, default=1)
    ap.add_argument("--preview-scale", type=int, default=1,
                    help="downsample the display fetch (2 = 540p preview, "
                         "a quarter of the 1080p bytes)")
    args = ap.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    # viewer defaults: smaller interactive resolution unless overridden
    cfg, scene, cam = _build(args)
    r = Renderer(scene, cfg, sun_position=tuple(args.sun))
    if args.terminal:
        TerminalViewer(r, cam).show()
    else:
        HttpViewer(r, cam, port=args.port,
                   steps_per_frame=args.steps_per_frame,
                   preview_scale=args.preview_scale).serve()


if __name__ == "__main__":
    main()
