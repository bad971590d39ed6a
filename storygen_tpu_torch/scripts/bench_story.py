"""p50 latency of a 4-frame story.

  python -m storygen_tpu_torch.scripts.bench_story [--reuse-latents]
      [--fused] [--conv fused]

The JAX package's scripts/bench_story.py: frame 1 in stage "no", frames
2-4 in stage "auto-regressive" on the 1, 2 and 3 frames before them, at
512 x 512, DDIM-50, guidance 7.0 and image guidance 3.5, with the
full-width SD-1.5 + VLCM UNet and VAE from seeded random weights in
bf16. Nothing leaves the device inside a story: the history is kept as
decoded pixels (n, B, 512, 512, 3) in [0, 1], which each frame
VAE-encodes (`StoryGenSampler.encode_ref_latents`) with one fixed
posterior draw per reference count, as the JAX script reuses one key.

--reuse-latents (or STORY_REUSE_LATENTS=1) feeds each frame's final
latents forward instead of its re-encoded pixels; --fused (or
STORY_FUSED=1) runs the whole story as `StoryGenSampler.story_rollout`,
which encodes each frame once, on draws seeded by the story.

One untimed story warms up; with STORY_BENCH_GATE=<path> the script then
waits until that file exists. Three stories are timed, each on its own
latents and captions, each frame's latents moved by 1e-6 times the
previous frame's mean (fused: the captions' embeddings, by the previous
story's), so that stories chain and never repeat. Prints one JSON line:
the p50, every time, 4 / p50 as frames/s, each story's frames' times on
the card's timeline and on the host's clock, the conv configuration and
the card's facts (utils/device.py::card_facts).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from storygen_tpu_torch.pipeline import StoryGenSampler, seeded_draws
from storygen_tpu_torch.scripts.bench import (GUIDANCE, IMAGE_GUIDANCE,
                                              TEXT_LEN, Marks, normal,
                                              synchronize)
from storygen_tpu_torch.scripts.common import (add_conv_flag, add_device_flag,
                                               full_width_models)
from storygen_tpu_torch.utils.device import (card_facts, facts_tag,
                                             resolve_device)

FRAMES, MAX_REFS = 4, 3
WARMUP_SEED = 99


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reuse-latents", action="store_true",
                    default=os.environ.get("STORY_REUSE_LATENTS") == "1",
                    help="feed each frame's final latents forward instead "
                         "of decode -> re-encode")
    ap.add_argument("--fused", action="store_true",
                    default=os.environ.get("STORY_FUSED") == "1",
                    help="the whole story as StoryGenSampler.story_rollout")
    add_conv_flag(ap)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.reuse_latents and args.fused:
        ap.error("--fused keeps the decode -> encode feedback; "
                 "--reuse-latents is another conditioning: pick one")
    return args


class Story:
    """The story's fixed inputs (bench_story.py:56-59): the empty
    caption's embedding (B, 77, D) * 0.02, the zero latents * 0.01 and
    the reference noise, each from its own generator; and the posterior
    draw of n reference frames, (n*B, h, w, 4), one per n."""

    def __init__(self, sampler: StoryGenSampler, batch: int, height: int,
                 steps: int, dev):
        unet = sampler.unet
        self.sampler, self.steps, self.dev = sampler, steps, dev
        self.text = (batch, TEXT_LEN, unet.config.cross_attention_dim)
        self.lat = (batch, height // 8, height // 8, unet.config.in_channels)
        self.text_u = normal(dev, 1, self.text, 0.02)
        self.zero = normal(dev, 4, self.lat, 0.01)
        self.noise = normal(dev, 7, self.lat)
        self.posterior = {n: normal(dev, 1, (n * batch,) + self.lat[1:])
                          for n in range(1, MAX_REFS + 1)}

    def draws(self, seed: int) -> Tuple[List[torch.Tensor],
                                        List[torch.Tensor]]:
        """A story's four latents (B, h, w, 4) and four captions'
        embeddings (B, 77, D) * 0.02, in that order from one generator
        seeded `seed`."""
        g = torch.Generator(device=self.dev).manual_seed(seed)
        lats = [torch.randn(self.lat, generator=g, device=self.dev)
                for _ in range(FRAMES)]
        texts = [torch.randn(self.text, generator=g, device=self.dev) * 0.02
                 for _ in range(FRAMES)]
        return lats, texts

    def per_frame(self, seed: int, salt: torch.Tensor, reuse: bool,
                  marks: Optional[Marks] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One story frame by frame (bench_story.py:74-99, :114-138),
        marking `marks` after each frame; returns its frames (4, B, H, W,
        3) and the last frame's mean."""
        s = self.sampler
        lats, texts = self.draws(seed)
        hist, frames = [], []
        for k in range(FRAMES):
            lat0 = lats[k] + salt.float() * 1e-6
            n = min(k, MAX_REFS)
            if n == 0:
                lat = s.sample(lat0, self.text_u, texts[k], None, None, None,
                               None, self.noise, GUIDANCE, IMAGE_GUIDANCE,
                               stage="no", num_inference_steps=self.steps)
            else:
                h = torch.stack(hist[-n:])
                refs = h if reuse else s.encode_ref_latents(
                    h, self.posterior[n])
                lat = s.sample(
                    lat0, self.text_u, texts[k], refs, self.zero,
                    self.text_u[None].expand((n,) + self.text),
                    torch.stack(texts[:n]), self.noise, GUIDANCE,
                    IMAGE_GUIDANCE, stage="auto-regressive",
                    num_inference_steps=self.steps)
            img = s.decode(lat)
            salt = img.mean()
            frames.append(img)
            hist.append(lat if reuse else img)
            if marks is not None:
                marks.mark()
        return torch.stack(frames), salt

    def fused(self, seed: int, salt: torch.Tensor, draw=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One story as story_rollout (bench_story.py:101-112) on the
        captions of `draws(seed)` moved by salt * 1e-6, with `draw` (by
        default seeded_draws(device, seed)); returns its frames and their
        mean."""
        _, texts = self.draws(seed)
        text_cs = torch.stack(texts) + salt.float() * 1e-6
        out = self.sampler.story_rollout(
            self.text_u, text_cs, draw or seeded_draws(self.dev, seed),
            GUIDANCE, IMAGE_GUIDANCE, num_inference_steps=self.steps,
            max_refs=MAX_REFS, height=self.lat[1] * 8,
            width=self.lat[2] * 8)
        return out, out.mean()


def run(models: dict, *, reuse: bool = False, fused: bool = False,
        steps: int = 50, stories: int = 3, batch: int = 1,
        height: int = 512, conv: str = "default", device=None
        ) -> Tuple[dict, List[torch.Tensor]]:
    """Time `stories` chained stories after one warm-up on `models` (a
    bundle with "unet" and "vae" on `device`); returns the JSON line and
    the timed stories' frames (4, B, H, W, 3), left on the device. The
    line has every story's time in order ("times") beside the sorted ones,
    and each story's frames' times (`Marks`; the fused story has one
    interval, the whole story)."""
    if reuse and fused:
        raise ValueError("reuse and fused are two different stories")
    dev = resolve_device(device)
    story = Story(StoryGenSampler(models["unet"], models["vae"], device=dev),
                  batch, height, steps, dev)

    def one(seed, salt, marks=None):
        if not fused:
            return story.per_frame(seed, salt, reuse, marks)
        out = story.fused(seed, salt)
        if marks is not None:
            marks.mark()
        return out

    t0 = time.perf_counter()
    _, salt = one(WARMUP_SEED, torch.zeros((), device=dev))
    synchronize(dev)
    tag = facts_tag(card_facts(dev))
    print(f"warmup: {time.perf_counter() - t0:.1f} s {tag}", file=sys.stderr)
    gate = os.environ.get("STORY_BENCH_GATE")
    if gate:
        print(f"warm; waiting for gate file {gate} {tag}", file=sys.stderr)
        while not os.path.exists(gate):
            time.sleep(5)
        print(f"gate open; timing {facts_tag(card_facts(dev))}",
              file=sys.stderr)
    times, outs, parts = [], [], []
    for i in range(stories):
        t0 = time.perf_counter()
        marks = Marks(dev)
        frames, salt = one(i, salt, marks)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
        outs.append(frames)
        parts.append(marks.times("frames"))
    p50 = statistics.median_high(times)
    line = {"metric": f"story_p50_latency_{FRAMES}frame_{height}px_"
                      f"ddim{steps}" + ("_reuse_latents" if reuse else "")
                      + ("_fused" if fused else ""),
            "value": p50, "unit": "s/story", "all_times": sorted(times),
            "frames_per_sec_equiv": FRAMES / p50, "conv": conv,
            "times": times, **{k: [p[k] for p in parts] for k in parts[0]},
            **card_facts(dev)}
    return line, outs


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    models = full_width_models(dev, args.conv)
    line, _ = run(models, reuse=args.reuse_latents, fused=args.fused,
                  conv=args.conv, device=dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
