"""Story inference from a diffusers folder.

  python -m storygen_tpu_torch.scripts.inference \\
      --ckpt ./ckpt/stable-diffusion-v1-5 --logdir ./out \\
      --prompt "The fox finds a lantern." "The fox carries it home." \\
      --num_inference_steps 40 --guidance_scale 7 --image_guidance_scale 3.5

Several prompts run a story (frame k conditioned on the frames before it)
and write story_frame<k>.png; one prompt runs `--stage` with the
`--ref_image` frames and their `--ref_prompt` captions and writes
`--num_sample_per_prompt` samples as <seed + s>_output.png. Reference
images are read as RGB in [0, 1] at 512 x 512. Draws come from
`seeded_draws(device, --seed)`.
"""
from __future__ import annotations

import argparse
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from storygen_tpu_torch.data.datasets import load_rgb
from storygen_tpu_torch.pipeline import seeded_draws
from storygen_tpu_torch.scripts.common import add_device_flag, load_pipeline
from storygen_tpu_torch.utils.image import write_png


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="diffusers-layout checkpoint folder")
    ap.add_argument("--logdir", default="./inference_out")
    ap.add_argument("--stage", default="auto-regressive",
                    choices=["no", "multi-image-condition",
                             "auto-regressive"])
    ap.add_argument("--prompt", required=True, nargs="+",
                    help="one caption: one frame; several: a story")
    ap.add_argument("--ref_image", nargs="*", default=[])
    ap.add_argument("--ref_prompt", nargs="*", default=[])
    ap.add_argument("--num_inference_steps", type=int, default=40)
    ap.add_argument("--guidance_scale", type=float, default=7.0)
    ap.add_argument("--image_guidance_scale", type=float, default=3.5)
    ap.add_argument("--num_sample_per_prompt", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", default=True,
                    help="bf16 weights (always on, as in the JAX script)")
    ap.add_argument("--sampler", default="ddim",
                    choices=["ddim", "dpm++", "pndm", "lms", "euler",
                             "euler_a"])
    ap.add_argument("--eta", type=float, default=0.0,
                    help="DDIM stochasticity")
    ap.add_argument("--ref_feature_interval", type=int, default=1,
                    help="recompute the reference features every k-th step")
    ap.add_argument("--reuse_latents", action="store_true",
                    help="story: condition on the earlier frames' final "
                         "latents, not on their decoded and re-encoded "
                         "pixels")
    ap.add_argument("--fused", action="store_true",
                    help="story: run story_rollout (each frame encoded "
                         "once; the same draws)")
    ap.add_argument("--normalize_refs", action="store_true",
                    help="story: feed history frames in [-1, 1], not in "
                         "the reference checkpoints' [0, 1]")
    add_device_flag(ap)
    return ap.parse_args(argv)


def to_u8(image: np.ndarray) -> np.ndarray:
    """A [0, 1] frame as the PNG's uint8 pixels."""
    return (image * 255).astype(np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    pipe = load_pipeline(args.ckpt, args.device,
                         torch.bfloat16 if args.bf16 else torch.float32)
    refs = None
    if args.ref_image:
        imgs = [load_rgb(p, 512).astype(np.float32) / 255.0
                for p in args.ref_image]
        refs = np.stack(imgs)[:, None]  # (N, B=1, H, W, 3)
    common = dict(num_inference_steps=args.num_inference_steps,
                  guidance_scale=args.guidance_scale,
                  image_guidance_scale=args.image_guidance_scale,
                  sampler=args.sampler, eta=args.eta,
                  ref_feature_interval=args.ref_feature_interval)
    os.makedirs(args.logdir, exist_ok=True)
    if len(args.prompt) > 1:
        frames = pipe.generate_story(
            args.prompt, first_frame=None if refs is None else refs[0, 0],
            first_caption=args.ref_prompt[0] if args.ref_prompt else None,
            normalize_refs=args.normalize_refs,
            reuse_latents=args.reuse_latents, fused=args.fused,
            seed=args.seed, **common)
        for i, f in enumerate(frames):
            write_png(os.path.join(args.logdir, f"story_frame{i}.png"),
                      to_u8(f))
        print(f"saved {len(frames)}-frame story")
        return
    out = pipe(stage=args.stage, prompt=args.prompt, image_prompt=refs,
               prev_prompt=[[p] for p in args.ref_prompt] or None,
               draw=functools.partial(seeded_draws(pipe.device, args.seed),
                                      0),
               num_images_per_prompt=args.num_sample_per_prompt, **common)
    for s in range(args.num_sample_per_prompt):
        write_png(os.path.join(args.logdir, f"{args.seed + s}_output.png"),
                  to_u8(out[s]))
    print(f"saved {args.num_sample_per_prompt} samples")


if __name__ == "__main__":
    main()
