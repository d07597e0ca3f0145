"""Orbit viewer over HTTP, with live stage-1 training.

Port of ``dreamgaussian_tpu/cli/serve.py``: loads a gaussian PLY (rendered
by kernel K1 on the card) or a mesh (kernel K3) and answers, on one page
with drag-to-orbit, wheel-to-zoom, pan and a mode selector:

- ``/``: the page;
- ``/render?elev=&azim=&radius=&mode=image|depth|alpha&tx=&ty=&tz=``: a
  PNG (``utils/png.encode_png``) of the view orbiting the target (tx, ty,
  tz);
- ``/status``: JSON ``{"live", "training", "step", "loss"}``;
- ``/train?on=1|0``: starts or pauses live training.

Live mode (``--train --config <yaml> [key=value ...]``) builds a
``Stage1Trainer`` from the config (guidance as ``cli.main`` builds it) and
runs ``train_step`` in a background thread under the lock the renders
take (kernels K1 and K2), serving the current state.

    python -m dreamgaussian_tpu_torch.cli.serve logs/name_model.ply --port 8000
    python -m dreamgaussian_tpu_torch.cli.serve --train --config configs/image.yaml \\
        input=data/name_rgba.png save_path=name [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .. import resolve_device
from ..utils.camera import Camera, orbit_camera
from .render import load_artifact, render_view

_PAGE = """<!DOCTYPE html>
<html><head><title>dreamgaussian_tpu_torch viewer</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:0 }
#bar { padding:8px } img { display:block; margin:0 auto; cursor:grab }
select,button { background:#222; color:#ddd; border:1px solid #555 }
</style></head><body>
<div id="bar">
 mode <select id="mode"><option>image</option><option>depth</option>
 <option>alpha</option></select>
 <label id="trainbox" style="display:none"><input type="checkbox" id="train"/> train</label>
 <span id="stat"></span> <span id="tstat"></span>
</div>
<img id="view" width="512" height="512"/>
<script>
let elev=0, azim=0, radius=2.0, tx=0, ty=0, tz=0;
let drag=null, pan=null, inflight=false, dirty=true;
const img=document.getElementById('view');
const mode=document.getElementById('mode');
function refresh(){
  if(inflight){dirty=true;return}
  inflight=true; dirty=false;
  const t0=performance.now();
  const u=`/render?elev=${elev.toFixed(1)}&azim=${azim.toFixed(1)}`+
          `&radius=${radius.toFixed(2)}&mode=${mode.value}`+
          `&tx=${tx.toFixed(4)}&ty=${ty.toFixed(4)}&tz=${tz.toFixed(4)}`;
  fetch(u).then(r=>r.blob()).then(b=>{
    img.src=URL.createObjectURL(b);
    document.getElementById('stat').textContent=
      ` elev ${elev.toFixed(0)} azim ${azim.toFixed(0)} r ${radius.toFixed(2)}`+
      ` (${(performance.now()-t0).toFixed(0)} ms)`;
    inflight=false; if(dirty) refresh();
  });
}
img.onmousedown=e=>{
  if(e.button===2||e.shiftKey) pan=[e.clientX,e.clientY];
  else drag=[e.clientX,e.clientY];
  e.preventDefault()};
img.oncontextmenu=e=>e.preventDefault();
window.onmouseup=()=>{drag=null;pan=null};
window.onmousemove=e=>{
  if(pan){
    // pan the orbit target in the camera plane (right-drag/shift-drag,
    // the dearpygui middle-drag analogue)
    const az=azim*Math.PI/180, el=elev*Math.PI/180;
    const sx=[Math.cos(az),0,-Math.sin(az)];             // camera right
    const sy=[Math.sin(el)*Math.sin(az),Math.cos(el),
              Math.sin(el)*Math.cos(az)];                // camera up
    const s=0.0015*radius, dx=e.clientX-pan[0], dy=e.clientY-pan[1];
    tx+=s*(-dx*sx[0]+dy*sy[0]); ty+=s*(-dx*sx[1]+dy*sy[1]);
    tz+=s*(-dx*sx[2]+dy*sy[2]);
    pan=[e.clientX,e.clientY]; refresh(); return;
  }
  if(!drag) return;
  azim-= (e.clientX-drag[0])*0.5; elev+=(e.clientY-drag[1])*0.5;
  elev=Math.max(-89,Math.min(89,elev));
  drag=[e.clientX,e.clientY]; refresh();
};
img.onwheel=e=>{e.preventDefault();radius*=Math.pow(1.1,e.deltaY>0?1:-1);
  radius=Math.max(0.5,Math.min(10,radius)); refresh();};
mode.onchange=refresh;
const trainCb=document.getElementById('train');
fetch('/status').then(r=>r.json()).then(st=>{
  if(st.live){document.getElementById('trainbox').style.display='inline';
    trainCb.checked=st.training;
    setInterval(()=>{fetch('/status').then(r=>r.json()).then(st=>{
      document.getElementById('tstat').textContent=
        `step ${st.step} loss ${st.loss===null?'-':st.loss.toFixed(3)}`;
      if(st.training) refresh();
    })}, 1000);}
});
trainCb&&(trainCb.onchange=()=>fetch('/train?on='+(trainCb.checked?1:0)));
refresh();
</script></body></html>"""


class ViewerState:
    """What the viewer shows: a loaded artifact, or a live trainer whose
    steps run in a background thread until ``close``."""

    def __init__(self, path: str | None, size: int = 512, fovy_deg: float = 49.1,
                 trainer=None, device="cuda"):
        self.size = size
        self.fovy = math.radians(fovy_deg)
        self.lock = threading.Lock()
        self.trainer = trainer
        self.training = False
        self.last_loss = None
        self._stop = threading.Event()
        if trainer is not None:
            self.kind, self.device = "live", trainer.device
            self._thread = threading.Thread(target=self._train_loop, daemon=True)
            self._thread.start()
            return
        self.device = resolve_device(device)
        self.kind, self.artifact = load_artifact(path, self.device)

    def _train_loop(self):
        """Stage-1 steps while training is on, until ``iters`` or ``close``;
        each under the lock the renders take."""
        total = self.trainer.opt.get("iters", 500)
        while not self._stop.is_set():
            if not self.training or self.trainer.step >= total:
                self._stop.wait(0.1)
                continue
            with self.lock:
                loss = float(self.trainer.train_step())
            self.last_loss = loss
            # Out of the lock for a moment: a render waiting on it takes it
            # (the lock is not fair; a loop that takes it again at once
            # starves the renders until training ends).
            self._stop.wait(0.001)

    def close(self) -> None:
        """End the training thread (live mode) after the step in flight."""
        self._stop.set()
        if self.trainer is not None:
            self._thread.join()

    def render(self, elev: float, azim: float, radius: float, mode: str, target=None) -> np.ndarray:
        """uint8 [size, size, 3]: the image, the depth min-max normalised, or the alpha."""
        cam = Camera.from_pose(orbit_camera(elev, azim, radius, target=target),
                               self.size, self.size, self.fovy, self.fovy)
        with self.lock:
            if self.kind == "live":
                out = self.trainer.render_view(cam)
                image, depth, alpha = out.image, out.depth, out.alpha
            else:
                image, depth, alpha = render_view(self.kind, self.artifact, cam, self.device)
        if mode == "depth":
            d = depth.cpu().numpy()
            lo, hi = d.min(), d.max()
            img = np.repeat(((d - lo) / (hi - lo + 1e-8))[..., None], 3, axis=-1)
        elif mode == "alpha":
            img = np.repeat(alpha.cpu().numpy()[..., None], 3, axis=-1)
        else:
            img = image.cpu().numpy()
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_handler(state: ViewerState):
    from ..utils.png import encode_png

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str | None):
            self.send_response(200)
            if ctype:
                self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif url.path == "/status":
                self._send(json.dumps({
                    "live": state.kind == "live",
                    "training": state.training,
                    "step": state.trainer.step if state.trainer else 0,
                    "loss": state.last_loss,
                }).encode(), "application/json")
            elif url.path == "/train":
                state.training = q.get("on", ["0"])[0] == "1"
                self._send(b"ok", None)
            elif url.path == "/render":
                arg = lambda k, d: float(q.get(k, [d])[0])  # noqa: E731
                img = state.render(arg("elev", "0"), arg("azim", "0"), arg("radius", "2"),
                                   q.get("mode", ["image"])[0],
                                   target=np.array([arg("tx", "0"), arg("ty", "0"), arg("tz", "0")],
                                                   dtype=np.float32))
                self._send(encode_png(img), "image/png")
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def make_live_state(config: str, extras: list, size: int) -> ViewerState:
    """A ``Stage1Trainer`` from a config (its ``device`` key, default
    ``cuda``) for the live mode."""
    from ..train import Stage1Trainer
    from ..utils.config import load_with_cli
    from .main import build_guidances, load_reference

    opt = load_with_cli(config, extras)
    device = resolve_device(opt.get("device", "cuda"))
    ref_rgb, ref_mask = load_reference(opt)
    trainer = Stage1Trainer(opt, ref_rgb=ref_rgb, ref_mask=ref_mask,
                            guidance_fns=build_guidances(opt, ref_rgb, device),
                            capacity=opt.get("capacity", 16384), seed=opt.get("seed", 0),
                            device=device)
    return ViewerState(None, size=size, trainer=trainer)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch orbit viewer")
    ap.add_argument("path", nargs="?", help=".ply gaussians or mesh")
    ap.add_argument("--train", action="store_true", help="live-training mode (needs --config)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="the artifact's device (live mode: the "
                                                     "config's device key)")
    args, extras = ap.parse_known_args(argv)

    if args.train:
        if not args.config:
            raise SystemExit("--train needs --config <yaml> [key=val ...]")
        state = make_live_state(args.config, extras, args.size)
    else:
        if not args.path:
            raise SystemExit("pass an artifact path, or --train --config")
        state = ViewerState(args.path, size=args.size, device=args.device)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(state))
    print(f"[INFO] viewer at http://localhost:{args.port}/ ({state.kind})")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        state.close()


if __name__ == "__main__":
    main(sys.argv[1:])
