"""Story serving over HTTP (standard library only).

  python -m storygen_tpu_torch.scripts.serve --ckpt <folder> --port 8500

    POST /story    {"prompts": ["...", ...], "num_inference_steps": 50,
                    "guidance_scale": 7.0, "image_guidance_scale": 3.5,
                    "sampler": "ddim", "seed": 0}
                -> {"frames": [<base64 PNG>, ...], "latency_s": ...}
    GET  /healthz  -> {"ok": true, "devices": N}

One process owns the card; requests run one at a time behind a lock. The
request's seed feeds `seeded_draws`. A bad request answers 400, a failure
500; the server keeps running. The JAX script's tensor-parallel `--tp`
has no counterpart yet.
"""
from __future__ import annotations

import argparse
import base64
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from storygen_tpu_torch.scripts.common import add_device_flag, load_pipeline
from storygen_tpu_torch.utils.image import encode_png

ALLOWED_KEYS = {
    "prompts", "num_inference_steps", "height", "width", "guidance_scale",
    "image_guidance_scale", "sampler", "seed", "max_refs", "normalize_refs",
    "reuse_latents", "fused",
}


class StoryService:
    """A StoryGenPipeline behind request validation and a lock; the HTTP
    layer is separate, so tests drive it in process."""

    def __init__(self, pipe):
        self.pipe = pipe
        self._lock = threading.Lock()  # one sampler run at a time

    def handle_story(self, req: dict) -> dict:
        unknown = set(req) - ALLOWED_KEYS
        if unknown:
            raise ValueError(f"unknown fields: {sorted(unknown)}")
        prompts = req.get("prompts")
        if (not isinstance(prompts, list) or not prompts
                or not all(isinstance(p, str) for p in prompts)):
            raise ValueError("'prompts' must be a non-empty list of strings")
        kw = {}
        for k in ("num_inference_steps", "height", "width", "seed",
                  "max_refs"):
            if k in req:
                kw[k] = int(req[k])
        for k in ("guidance_scale", "image_guidance_scale"):
            if k in req:
                kw[k] = float(req[k])
        if "sampler" in req:
            kw["sampler"] = str(req["sampler"])
        for k in ("normalize_refs", "reuse_latents", "fused"):
            if k in req:
                kw[k] = bool(req[k])

        t0 = time.perf_counter()
        with self._lock:
            frames = self.pipe.generate_story(prompts, **kw)
        dt = time.perf_counter() - t0
        out = [base64.b64encode(encode_png(
            (np.clip(np.asarray(f), 0, 1) * 255).astype(np.uint8))).decode(
                "ascii") for f in frames]
        return {"frames": out, "latency_s": round(dt, 3)}


def make_handler(service: StoryService):
    class Handler(BaseHTTPRequestHandler):
        server_version = "StoryGenTorch"

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                dev = service.pipe.device
                self._reply(200, {"ok": True, "devices": (
                    torch.cuda.device_count() if dev.type == "cuda" else 1)})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/story":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                self._reply(200, service.handle_story(req))
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # reported; the server keeps serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}",
                  file=sys.stderr)

    return Handler


def serve(pipe, host: str, port: int) -> ThreadingHTTPServer:
    """The server (bound, not yet serving); the caller runs
    serve_forever() and, from another thread, shutdown()."""
    return ThreadingHTTPServer((host, port), make_handler(StoryService(pipe)))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="diffusers-layout checkpoint folder")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500,
                    help="0 picks a free port (printed)")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         on_ready: Optional[Callable[[ThreadingHTTPServer], None]] = None
         ) -> None:
    """Serve until the server is shut down. `on_ready` is called with the
    bound server before it serves (a caller in the same process learns the
    port and can shut it down from there)."""
    args = parse_args(argv)
    srv = serve(load_pipeline(args.ckpt, args.device), args.host, args.port)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port}", file=sys.stderr, flush=True)
    if on_ready is not None:
        on_ready(srv)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
