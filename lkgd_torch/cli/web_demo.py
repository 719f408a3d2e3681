"""A web demo on the standard library alone (counterpart of ``lkgd_tpu/cli/web_demo.py``).

One HTML page whose script posts base64 frames as JSON, and a ``/generate`` endpoint that
runs the pipeline and answers with an mp4; every error of the pipeline becomes an HTTP 500
carrying its message. The uint8 frames go into the mp4 as they are (OpenCV's ``mp4v``;
the JAX handler hands them to a writer that takes [0, 1] floats, which saturates every
non-zero level: ROADMAP.md Queue 3). ``cli/gradio_demo.py`` prefers Gradio where it is
installed and falls back to this server. The handler threads of ``ThreadingHTTPServer`` run
the pipeline, so its kernels launch off the main thread.

  python -m lkgd_torch.cli.web_demo [--mode base|trans|cogvideox] [--port 7860]

``base`` and ``trans`` build the pipeline of ``cli/run_inference_svd.py`` (14x576x1024, 25
steps by default), ``cogvideox`` the CogVideoX image-to-video pipeline and VAE of
``cli/run_inference_cogvideox.py`` (the motion-bucket and end-frame controls ignored, the T5
embeddings from ``--prompt-embeds`` or zeros). Random weights from ``--seed``; a request's
``seed`` seeds its noise. It runs on the card: ``--device`` defaults to ``cuda`` and a
machine without one fails unless ``--device cpu`` is given. ``--weights`` is refused: no
checkpoint is in the repository (ROADMAP.md Queue 1, item 6 for SVD, item 11 for CogVideoX).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>LKGD {mode}</title><style>
body {{ font-family: sans-serif; max-width: 640px; margin: 2em auto; }}
label {{ display: block; margin-top: 1em; }}
video {{ width: 100%; margin-top: 1em; }}
#status {{ color: #666; }}
</style></head><body>
<h2>LKGD &mdash; {mode} pipeline</h2>
<label>start frame <input type="file" id="start" accept="image/*"></label>
<label class="trans-only">end frame <input type="file" id="end" accept="image/*"></label>
<label>seed <input type="number" id="seed" value="23123134"></label>
<label>motion bucket <input type="range" id="motion" min="1" max="255" value="127"></label>
<label>fps <input type="range" id="fps" min="1" max="30" value="7"></label>
<button id="go">generate</button> <span id="status"></span>
<video id="out" controls></video>
<script>
const b64 = f => new Promise((res, rej) => {{
  if (!f) return res(null);
  const r = new FileReader();
  r.onload = () => res(r.result.split(',')[1]);
  r.onerror = rej; r.readAsDataURL(f);
}});
if ("{mode}" !== "trans")
  document.querySelectorAll(".trans-only").forEach(e => e.style.display = "none");
document.getElementById('go').onclick = async () => {{
  const status = document.getElementById('status');
  status.textContent = 'generating…';
  const body = {{
    start: await b64(document.getElementById('start').files[0]),
    end: await b64(document.getElementById('end').files[0]),
    seed: +document.getElementById('seed').value,
    motion_bucket_id: +document.getElementById('motion').value,
    fps: +document.getElementById('fps').value,
  }};
  const r = await fetch('/generate', {{method: 'POST', body: JSON.stringify(body)}});
  if (!r.ok) {{ status.textContent = 'error: ' + await r.text(); return; }}
  document.getElementById('out').src = URL.createObjectURL(await r.blob());
  status.textContent = 'done';
}};
</script></body></html>
"""
WEIGHTS = {"base": "ROADMAP.md Queue 1, item 6", "trans": "ROADMAP.md Queue 1, item 6",
           "cogvideox": "ROADMAP.md Queue 1, item 11"}


def _decode_image(b64_data: str) -> np.ndarray:
    """base64 image file -> (H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64_data))).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def make_handler(generate_fn: Callable, mode: str):
    """``generate_fn(start, end, seed, motion_bucket_id, fps) -> (T, H, W, 3) uint8``;
    ``start``/``end`` are (H, W, 3) float32 in [0, 1] (``end`` None unless given)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # tests and servers stay quiet
            pass

        def _reply(self, code: int, kind: str, data: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                self.send_error(404)
                return
            self._reply(200, "text/html; charset=utf-8", _PAGE.format(mode=mode).encode())

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                start = _decode_image(req["start"])
                end = _decode_image(req["end"]) if req.get("end") else None
                fps = int(req.get("fps", 7))
                video = generate_fn(start, end, int(req.get("seed", 23123134)),
                                    int(req.get("motion_bucket_id", 127)), fps)
            except Exception as e:  # the server keeps serving; the page gets the error
                traceback.print_exc()
                self._reply(500, "text/plain", f"{type(e).__name__}: {e}".encode())
                return
            from lkgd_torch.data.video_io import write_mp4

            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "out.mp4")
                write_mp4(path, np.asarray(video, np.uint8), fps=fps)
                with open(path, "rb") as f:
                    data = f.read()
            self._reply(200, "video/mp4", data)

    return Handler


def make_server(generate_fn: Callable, mode: str = "base", port: int = 7860,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The server, bound (``port`` 0: an ephemeral port, ``server_address`` says which)."""
    return ThreadingHTTPServer((host, port), make_handler(generate_fn, mode))


def serve(generate_fn: Callable, mode: str = "base", port: int = 7860) -> None:
    httpd = make_server(generate_fn, mode, port)
    print(f"serving the LKGD {mode} demo on http://0.0.0.0:{port}")
    httpd.serve_forever()


def build_generate_fn(pipe, mode: str) -> Callable:
    """The pipeline adapter shared with the Gradio front end: the start frame (and in trans
    mode the end frame) resized and cropped to the pipeline's size, the request's seed
    seeding a generator on the pipeline's device; frames -> uint8 (the first stream in
    trans mode). One request at a time reaches the pipeline."""
    from lkgd_torch.data.video_io import process_frames

    lock = threading.Lock()
    cfg = pipe.config

    def generate(start, end, seed, motion_bucket_id, fps):
        del motion_bucket_id, fps  # the pipeline's own config sets both, as in JAX
        img = process_frames(start[None], cfg.height, cfg.width)[0]
        with lock:
            generator = torch.Generator(device=pipe.device).manual_seed(seed)
            if mode == "trans" and end is not None:
                eimg = process_frames(end[None], cfg.height, cfg.width)[0]
                video = pipe(img, eimg, generator=generator)[0]
            else:
                video = pipe(img[None], generator=generator)[0]
        return (np.clip(np.asarray(video), 0.0, 1.0) * 255).astype(np.uint8)

    return generate


def build_cogvideox_generate_fn(args) -> Callable:
    """CogVideoX image-to-video behind the same surface: the start frame encoded by the
    VAE, denoised with the request's seed, decoded; the motion-bucket and end-frame
    controls are SVD's and ignored."""
    from lkgd_torch.cli import run_inference_cogvideox as cog
    from lkgd_torch.data.video_io import process_frames

    cargs = cog.make_parser().parse_args(
        ["--image", "-", "--height", str(args.height), "--width", str(args.width),
         "--num-frames", str(args.num_frames), "--seed", str(args.seed), "--device",
         args.device] + (["--tiny"] if args.tiny else [])
        + (["--prompt-embeds", args.prompt_embeds] if args.prompt_embeds else []))
    pipe, vae = cog.build(cargs)
    prompt = cog.prompt_embeds(cargs, pipe.transformer.config)
    lock = threading.Lock()

    @torch.inference_mode()
    def generate(start, end, seed, motion_bucket_id, fps):
        del end, motion_bucket_id, fps
        img = process_frames(start[None], args.height, args.width)
        with lock:
            image = torch.from_numpy(img[None]).to(pipe.device) * 2.0 - 1.0
            latents = pipe(prompt, cog.encode(vae, image, cargs)[:, 0],
                           generator=torch.Generator(device=pipe.device).manual_seed(seed))
            video = cog.decode(vae, latents, cargs)[0, :args.num_frames].cpu().numpy()
        return (np.clip(video, 0.0, 1.0) * 255).astype(np.uint8)

    return generate


def build_svd(args, widths=None):
    """The base or trans pipeline of the inference CLI for the demo: its defaults (25 Euler
    steps, guidance 1 to 3, fps 7, motion bucket 127, noise augmentation 0.02) and the
    demo's size, decoded two frames a chunk; random weights from ``--seed``."""
    from lkgd_torch.cli import run_inference_svd as svd

    argv = ["--image", "-", "--mode", args.mode, "--height", str(args.height), "--width",
            str(args.width), "--num-frames", str(args.num_frames), "--decode-chunk-size", "2",
            "--seed", str(args.seed), "--device", args.device]
    return svd.build_pipeline(svd.make_parser().parse_args(argv), widths or svd.Widths())


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["base", "trans", "cogvideox"], default="base")
    p.add_argument("--prompt-embeds", help="cogvideox: .npy T5 embeddings")
    p.add_argument("--tiny", action="store_true", help="cogvideox: tiny widths (tests)")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--num-frames", type=int, default=14)
    p.add_argument("--seed", type=int, default=23123134)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    p.add_argument("--weights", help=argparse.SUPPRESS)  # refused, naming its item
    return p


def parse_args(argv=None):
    p = make_parser()
    args = p.parse_args(argv)
    if args.weights:
        p.error(f"--weights is not ported to lkgd_torch: no checkpoint is in the repository "
                f"({WEIGHTS[args.mode]}); weights are random from --seed")
    return args


def main(argv=None, widths=None) -> None:
    args = parse_args(argv)
    if args.mode == "cogvideox":
        serve(build_cogvideox_generate_fn(args), args.mode, args.port)
        return
    serve(build_generate_fn(build_svd(args, widths), args.mode), args.mode, args.port)


if __name__ == "__main__":
    main()
