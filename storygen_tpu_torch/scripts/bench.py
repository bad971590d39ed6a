"""Headline timer: frames/s of one auto-regressive story frame.

  python -m storygen_tpu_torch.scripts.bench [--batch 1] [--conv fused]

The operating point of the JAX package's bench.py: one auto-regressive
frame at 512 x 512, DDIM-50, guidance 7.0 and image guidance 3.5, 3
reference frames given as latents, so that every denoise step runs one
batched reference-cycle UNet pass (3B x 2 rows) and one main pass (3B
rows); the full-width SD-1.5 + VLCM UNet and VAE from seeded random
weights in bf16. It times `StoryGenSampler.sample` and `decode` alone: no
text or reference encode is inside. Each timed iteration starts from its
own latents, moved by 1e-6 times the previous image's mean (a device
tensor), so that no two frames repeat and the iterations form one chain;
the card is synchronised once, after the last. One untimed frame warms
up. A kernel that fails to build or launch raises; nothing falls back.

Prints one JSON line: the metric, its value and unit, each iteration's
time on the card's timeline and on the host's clock, the conv
configuration and the card's facts (utils/device.py::card_facts).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from storygen_tpu_torch.pipeline import StoryGenSampler
from storygen_tpu_torch.scripts.common import (add_conv_flag, add_device_flag,
                                               full_width_models)
from storygen_tpu_torch.utils.device import card_facts, resolve_device

N_REFS, GUIDANCE, IMAGE_GUIDANCE = 3, 7.0, 3.5
TEXT_LEN = 77


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per call (the JAX script's BENCH_BATCH)")
    add_conv_flag(ap)
    add_device_flag(ap)
    return ap.parse_args(argv)


def normal(dev, seed: int, shape, scale: float = 1.0) -> torch.Tensor:
    """N(0, scale^2) in fp32 from a generator of its own, seeded `seed`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(tuple(shape), generator=g, device=dev) * scale


def frame_inputs(unet, batch: int, height: int, iters: int,
                 dev) -> Dict[str, object]:
    """The frame's inputs (bench.py:84-92), each from its own generator:
    text embeddings (B, 77, D) * 0.02, refs (3, B, h, w, 4), zero latents
    * 0.01, the refs' captions' embeddings (3, B, 77, D) * 0.02, the
    reference noise; and "latents", one (B, h, w, 4) draw per timed
    iteration and one for the warm-up (the last)."""
    d = unet.config.cross_attention_dim
    lat = (batch, height // 8, height // 8, unet.config.in_channels)
    text, prev = (batch, TEXT_LEN, d), (N_REFS, batch, TEXT_LEN, d)
    return {"text_u": normal(dev, 1, text, 0.02),
            "text_c": normal(dev, 2, text, 0.02),
            "refs": normal(dev, 3, (N_REFS,) + lat),
            "zero": normal(dev, 4, lat, 0.01),
            "prev_u": normal(dev, 5, prev, 0.02),
            "prev_c": normal(dev, 6, prev, 0.02),
            "noise": normal(dev, 7, lat),
            "latents": [normal(dev, 42 + i, lat) for i in range(iters + 1)]}


def frame(sampler: StoryGenSampler, inp: dict, latents: torch.Tensor,
          salt: torch.Tensor, steps: int) -> torch.Tensor:
    """One frame from `latents` + salt * 1e-6: sample, then decode to
    (B, H, W, 3) in [0, 1]."""
    lat = sampler.sample(
        latents + salt.float() * 1e-6, inp["text_u"], inp["text_c"],
        inp["refs"], inp["zero"], inp["prev_u"], inp["prev_c"],
        inp["noise"], GUIDANCE, IMAGE_GUIDANCE, stage="auto-regressive",
        num_inference_steps=steps)
    return sampler.decode(lat)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Marks:
    """Per-interval times that need no synchronise between the intervals:
    `mark()` at each boundary reads the host's clock and, on a card,
    records a CUDA event on the current stream. After the final
    synchronise, `times(name)` gives each interval's milliseconds as
    "<name>_device_ms", between consecutive events on the card's timeline,
    its idle gaps included (None on the CPU), and "<name>_host_ms", on the
    host's clock: on a card the time to enqueue the interval's work, or
    longer where the host waited on the card."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.host: List[float] = []
        self.events: list = []
        self.mark()

    def mark(self) -> None:
        self.host.append(time.perf_counter())
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)

    def times(self, name: str) -> Dict[str, Optional[List[float]]]:
        pairs = list(zip(self.events, self.events[1:]))
        return {f"{name}_device_ms": ([a.elapsed_time(b) for a, b in pairs]
                                      if self.cuda else None),
                f"{name}_host_ms": [1e3 * (b - a) for a, b in
                                    zip(self.host, self.host[1:])]}


def run(models: dict, *, batch: int = 1, steps: int = 50, iters: int = 3,
        height: int = 512, conv: str = "default", device=None
        ) -> Tuple[dict, List[torch.Tensor]]:
    """Time `iters` chained frames after one warm-up on `models` (a bundle
    with "unet" and "vae" on `device`); returns the JSON line, with each
    iteration's times (`Marks`) beside the mean, and the timed iterations'
    images, left on the device."""
    dev = resolve_device(device)
    sampler = StoryGenSampler(models["unet"], models["vae"], device=dev)
    inp = frame_inputs(models["unet"], batch, height, iters, dev)
    lats = inp["latents"]
    salt = frame(sampler, inp, lats[-1], torch.zeros((), device=dev),
                 steps).mean()
    synchronize(dev)
    images = []
    t0 = time.perf_counter()
    marks = Marks(dev)
    for i in range(iters):
        img = frame(sampler, inp, lats[i], salt, steps)
        salt = img.mean()
        images.append(img)
        marks.mark()
    synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    line = {"metric": f"frames_per_sec_per_chip_{height}px_ddim{steps}_"
                      f"autoregressive_{N_REFS}ref",
            "value": batch / dt, "unit": "frames/s", "conv": conv,
            **marks.times("iter"), **card_facts(dev)}
    return line, images


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    models = full_width_models(dev, args.conv)
    line, _ = run(models, batch=args.batch, conv=args.conv, device=dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
