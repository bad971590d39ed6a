"""Story serving over HTTP (standard library only).

  python -m storygen_tpu_torch.scripts.serve --ckpt <folder> --port 8500

    POST /story    {"prompts": ["...", ...], "num_inference_steps": 50,
                    "guidance_scale": 7.0, "image_guidance_scale": 3.5,
                    "sampler": "ddim", "seed": 0}
                -> {"frames": [<base64 PNG>, ...], "latency_s": ...}
    GET  /healthz  -> {"ok": true, "devices": N}

One process owns the card; requests run one at a time behind a lock. The
request's seed feeds `seeded_draws`. A bad request answers 400, a failure
500; the server keeps running.

`--tp N` shards the UNet over N processes (parallel/tensor.py; the VAE and
CLIP stay replicated), launched together by torchrun (`torchrun
--nproc_per_node N -m storygen_tpu_torch.scripts.serve --tp N ...`) or
with the JAX package's environment names (JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID). Rank 0 owns the HTTP front end and
broadcasts each request to the other ranks, which wait for it; every rank
runs generate_story on its shards, and rank 0 replies. /healthz reports
the N devices. Shutting rank 0 down (SIGTERM, or `shutdown()` of the
server) stops every rank. The backend is NCCL unless `--backend gloo` is
named.
"""
from __future__ import annotations

import argparse
import base64
import json
import signal
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from storygen_tpu_torch.parallel import multihost
from storygen_tpu_torch.parallel import tensor as T
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

    def __init__(self, pipe, devices: Optional[int] = None):
        self.pipe = pipe
        self.devices = devices  # what /healthz reports (None: the host's)
        self._lock = threading.Lock()  # one sampler run at a time

    def generate(self, prompts, kw: dict):
        return self.pipe.generate_story(prompts, **kw)

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
            frames = self.generate(prompts, kw)
        dt = time.perf_counter() - t0
        out = [base64.b64encode(encode_png(
            (np.clip(np.asarray(f), 0, 1) * 255).astype(np.uint8))).decode(
                "ascii") for f in frames]
        return {"frames": out, "latency_s": round(dt, 3)}


class TensorParallelStoryService(StoryService):
    """Rank 0's service under --tp: each request is broadcast to the other
    ranks (`follow`) before every rank generates it."""

    def generate(self, prompts, kw: dict):
        dist.broadcast_object_list([(prompts, kw)], src=0)
        return super().generate(prompts, kw)

    def stop(self) -> None:
        """Tell the other ranks to leave `follow`."""
        with self._lock:
            dist.broadcast_object_list([None], src=0)


def follow(pipe) -> None:
    """A rank > 0 under --tp: run each request that rank 0 broadcasts
    until it broadcasts None. A request that fails here fails on rank 0
    too, which reports it."""
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return
        prompts, kw = msg[0]
        try:
            pipe.generate_story(prompts, **kw)
        except Exception:  # reported by rank 0; keep following
            traceback.print_exc()


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
                devices = service.devices or (
                    torch.cuda.device_count() if dev.type == "cuda" else 1)
                self._reply(200, {"ok": True, "devices": devices})
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


def serve(pipe, host: str, port: int,
          service: Optional[StoryService] = None) -> ThreadingHTTPServer:
    """The server (bound, not yet serving); the caller runs
    serve_forever() and, from another thread, shutdown()."""
    return ThreadingHTTPServer((host, port),
                               make_handler(service or StoryService(pipe)))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="diffusers-layout checkpoint folder")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500,
                    help="0 picks a free port (printed)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard the UNet over N "
                         "processes (launched by torchrun, or with the JAX "
                         "package's process environment names)")
    ap.add_argument("--backend", default="nccl",
                    help="torch.distributed backend under --tp: nccl "
                         "(default) or gloo")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         on_ready: Optional[Callable[[ThreadingHTTPServer], None]] = None
         ) -> None:
    """Serve until the server is shut down. `on_ready` is called with the
    bound server before it serves (a caller in the same process learns the
    port and can shut it down from there)."""
    args = parse_args(argv)
    if args.tp > 1:
        return main_tp(args, on_ready)
    srv = serve(load_pipeline(args.ckpt, args.device), args.host, args.port)
    run_server(srv, on_ready)


def run_server(srv: ThreadingHTTPServer,
               on_ready: Optional[Callable] = None) -> None:
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port}", file=sys.stderr, flush=True)
    if on_ready is not None:
        on_ready(srv)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def main_tp(args: argparse.Namespace,
            on_ready: Optional[Callable] = None) -> None:
    """--tp N: this process is one of the N ranks."""
    if not multihost.initialize(backend=args.backend, device=args.device):
        raise ValueError("--tp runs as N processes: launch them with torchrun"
                         " or the JAX package's process environment names")
    try:
        if dist.get_world_size() != args.tp:
            raise ValueError(f"--tp {args.tp} needs {args.tp} processes, not "
                             f"{dist.get_world_size()}")
        pipe = load_pipeline(args.ckpt, multihost.rank_device(args.device))
        mesh = T.make_tp_mesh(1, args.tp)
        T.shard_unet_params(pipe.sampler.unet, mesh)
        T.replicated_on(mesh, [pipe.vae, pipe.text_encoder])
        print(f"[serve] rank {mesh.rank}: UNet sharded over {args.tp} "
              f"ranks ({args.backend})", file=sys.stderr, flush=True)
        if mesh.rank:
            follow(pipe)
            return
        service = TensorParallelStoryService(pipe, devices=args.tp)
        srv = serve(pipe, args.host, args.port, service)
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
                target=srv.shutdown).start())
        try:
            run_server(srv, on_ready)
        finally:
            service.stop()
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
