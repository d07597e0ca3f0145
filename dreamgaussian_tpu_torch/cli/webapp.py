"""Two-stage web app: pick an input, run stage 1 or stage 2, see the result.

Port of ``dreamgaussian_tpu/cli/webapp.py``: one page with an input picker
(the ``*_rgba.png`` files of ``--data_dir``) and two buttons. Each runs
``cli.main.run`` (stage 1) or ``cli.main2.run`` (stage 2) on
``configs/image.yaml`` in a worker thread of this process, streams the
job's printed lines to the page, and ends in a 12-frame 256^2 orbit GIF
of the result (``cli/render.py``) with a link to the mesh. Routes: ``/``,
``/run?stage=1|2&input=``, ``/status``, ``/artifact?path=`` (files under
``--outdir`` only).

    python -m dreamgaussian_tpu_torch.cli.webapp --port 8090 [--data_dir data] \\
        [--outdir logs] [--fake_guidance] [--device cpu] [--extra key=value ...]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .. import resolve_device

ORBIT_FRAMES, ORBIT_SIZE = 12, 256      # the result's orbit GIF

_PAGE = """<!DOCTYPE html>
<html><head><title>dreamgaussian_tpu_torch</title><style>
body {{ background:#111; color:#ddd; font-family:monospace; margin:2em }}
select,button,input {{ background:#222; color:#ddd; border:1px solid #555;
  padding:4px }}
#log {{ white-space:pre-wrap; background:#000; padding:8px; height:16em;
  overflow-y:scroll; border:1px solid #333 }}
img {{ max-width:512px }}
a {{ color:#8cf }}
</style></head><body>
<h2>dreamgaussian_tpu_torch</h2>
input <select id="input">{options}</select>
<button onclick="run(1)">Generate 3D (stage 1)</button>
<button onclick="run(2)">Refine texture (stage 2)</button>
<div id="log"></div>
<div id="result"></div>
<script>
let timer=null;
function run(stage){{
  fetch(`/run?stage=${{stage}}&input=${{encodeURIComponent(
    document.getElementById('input').value)}}`).then(r=>r.json()).then(j=>{{
      if(j.error) log(j.error); else poll();
  }});
}}
function log(s){{ const el=document.getElementById('log');
  el.textContent=s; el.scrollTop=el.scrollHeight; }}
function poll(){{
  if(timer) clearTimeout(timer);
  fetch('/status').then(r=>r.json()).then(j=>{{
    log(j.log);
    if(j.running) timer=setTimeout(poll, 2000);
    else if(j.artifact) document.getElementById('result').innerHTML=
      `<p><img src="/artifact?path=${{encodeURIComponent(j.artifact)}}"/></p>`+
      (j.mesh?`<p><a href="/artifact?path=${{encodeURIComponent(j.mesh)}}"
        download>download mesh</a></p>`:'');
  }});
}}
poll();
</script></body></html>"""


class AppState:
    """The one job the app runs at a time, and its log."""

    def __init__(self, data_dir: str, outdir: str, extra: list[str], device="cuda"):
        self.data_dir = data_dir
        self.outdir = outdir
        self.device = resolve_device(device)
        self.extra = [*extra, f"device={self.device.type}"]
        self.lock = threading.Lock()
        self.running = False
        self.log: list[str] = []
        self.artifact = None
        self.mesh = None
        self.thread = None

    def emit(self, msg: str) -> None:
        with self.lock:
            self.log.append(msg)

    def launch(self, stage: int, input_path: str) -> str | None:
        """Start a stage-``stage`` job on ``input_path``; an error message
        when a job is running."""
        with self.lock:
            if self.running:
                return "a job is already running"
            self.running = True
            self.log = [f"[webapp] stage {stage} on {input_path}"]
            self.artifact = None
        self.thread = threading.Thread(target=self._work, args=(stage, input_path), daemon=True)
        self.thread.start()
        return None

    def _work(self, stage: int, input_path: str) -> None:
        from ..utils.config import load_with_cli
        from . import main as cli1
        from . import main2 as cli2
        from . import render as cli_render

        state = self

        class Tee(io.StringIO):
            def write(self, t):
                if t.strip():
                    state.emit(t.rstrip())
                return len(t)

        try:
            name = os.path.basename(input_path).replace("_rgba.png", "")
            opt = load_with_cli("configs/image.yaml", [
                f"input={input_path}", f"save_path={name}", f"outdir={self.outdir}", *self.extra])
            with contextlib.redirect_stdout(Tee()):
                stats = (cli1 if stage == 1 else cli2).run(opt)
                mesh = stats.get("mesh_path")
                gif = os.path.join(self.outdir, f"{name}_s{stage}.gif")
                target = stats.get("ply_path", mesh) if stage == 1 else mesh
                cli_render.main([target, "--out", gif, "--num_frames", str(ORBIT_FRAMES),
                                 "--size", str(ORBIT_SIZE), "--device", self.device.type])
            with self.lock:
                self.artifact = gif
                self.mesh = mesh
            self.emit("[webapp] done")
        except Exception:
            self.emit(traceback.format_exc())
        finally:
            with self.lock:
                self.running = False


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                inputs = sorted(glob.glob(os.path.join(state.data_dir, "*_rgba.png")))
                options = "".join(f'<option value="{p}">{os.path.basename(p)}</option>'
                                  for p in inputs)
                self._send(_PAGE.format(options=options).encode(), "text/html")
            elif url.path == "/run":
                err = state.launch(int(q.get("stage", ["1"])[0]), q.get("input", [""])[0])
                self._send(json.dumps({"error": err}).encode(), "application/json")
            elif url.path == "/status":
                with state.lock:
                    body = json.dumps({"running": state.running,
                                       "log": "\n".join(state.log[-200:]),
                                       "artifact": state.artifact, "mesh": state.mesh})
                self._send(body.encode(), "application/json")
            elif url.path == "/artifact":
                real = os.path.realpath(q.get("path", [""])[0])
                if not real.startswith(os.path.realpath(state.outdir) + os.sep):
                    self.send_response(403)
                    self.end_headers()
                    return
                with open(real, "rb") as f:
                    body = f.read()
                self._send(body, "image/gif" if real.endswith(".gif") else "application/octet-stream")
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch web app")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--data_dir", default="data")
    ap.add_argument("--outdir", default="logs")
    ap.add_argument("--fake_guidance", action="store_true")
    ap.add_argument("--extra", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    extra = list(args.extra) + (["fake_guidance=True"] if args.fake_guidance else [])
    os.makedirs(args.outdir, exist_ok=True)
    state = AppState(args.data_dir, args.outdir, extra, device=args.device)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(state))
    print(f"[INFO] webapp at http://localhost:{args.port}/")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main(sys.argv[1:])
