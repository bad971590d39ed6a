"""Renders for COCO val2017: one image per val image, in
"multi-image-condition" with its segment crops as refs, re-ranked by
PickScore when a scorer is given.

  python -m storygen_tpu_torch.scripts.inference_coco_val \\
      --ckpt <folder> --coco_root ./coco --logdir ./coco_val_out \\
      [--pickscore_processor <CLIP-H processor folder> \\
       --pickscore_model <PickScore_v1 folder> --num_samples 10 \\
       --samples_per_batch 5]

With a scorer (evaluation/clip_scores.py::PickScorer, on the same device)
image i gets `--num_samples` candidates, rendered `--samples_per_batch` at
a time as several images per prompt with the draws of
`seeded_draws(device, 1000 * i + s0)` (s0 the chunk's first candidate),
and the PickScore argmax is kept. Without one the JAX script keeps
candidate 0; here image i is then rendered once, with the draws of
`seeded_draws(device, 1000 * i)`, since no score chooses among the others.
An image whose output exists is skipped. Needs PIL and cv2 (the COCO
dataset), and PIL writes the output under the val image's own file name.
"""
from __future__ import annotations

import argparse
import functools
import os
from typing import Dict, Optional, Sequence

import numpy as np

from storygen_tpu_torch.data.datasets import COCOValMultiSegDataset
from storygen_tpu_torch.pipeline import seeded_draws
from storygen_tpu_torch.scripts.common import add_device_flag, load_pipeline


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--coco_root", required=True)
    ap.add_argument("--caption_dir", default=None)
    ap.add_argument("--logdir", default="./coco_val_out")
    ap.add_argument("--pickscore_processor", default=None,
                    help="local CLIP-H processor folder")
    ap.add_argument("--pickscore_model", default=None,
                    help="local PickScore_v1 folder")
    ap.add_argument("--num_samples", type=int, default=10,
                    help="candidates per val image (with a scorer)")
    ap.add_argument("--samples_per_batch", type=int, default=5,
                    help="candidates rendered per sampler call")
    ap.add_argument("--num_inference_steps", type=int, default=40)
    add_device_flag(ap)
    return ap.parse_args(argv)


def candidates(pipe, sample: dict, index: int, num_samples: int,
               samples_per_batch: int, num_inference_steps: int) -> list:
    """Image `index`'s candidates as uint8 arrays, in chunks of
    `samples_per_batch` images per prompt."""
    out = []
    per = max(1, min(samples_per_batch, num_samples))
    for s0 in range(0, num_samples, per):
        nb = min(per, num_samples - s0)
        imgs = pipe(stage="multi-image-condition", prompt=[sample["prompt"]],
                    image_prompt=sample["ref_images"][:, None],
                    prev_prompt=[[p] for p in sample["ref_prompts"]],
                    num_inference_steps=num_inference_steps,
                    num_images_per_prompt=nb,
                    draw=functools.partial(
                        seeded_draws(pipe.device, 1000 * index + s0), 0))
        out.extend((imgs[s] * 255).astype(np.uint8) for s in range(nb))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Render (and re-rank); returns each written file's kept candidate."""
    args = parse_args(argv)
    from PIL import Image
    pipe = load_pipeline(args.ckpt, args.device)
    scorer = None
    if args.pickscore_model:
        from storygen_tpu_torch.evaluation.clip_scores import PickScorer
        scorer = PickScorer(args.pickscore_processor, args.pickscore_model,
                            pipe.device)
    ds = COCOValMultiSegDataset(args.coco_root, caption_dir=args.caption_dir)
    os.makedirs(args.logdir, exist_ok=True)
    kept = {}
    for i in range(len(ds)):
        sample = ds[i]
        name = os.path.basename(sample["image_path"])
        out_path = os.path.join(args.logdir, name)
        if os.path.exists(out_path):
            continue
        cands = candidates(pipe, sample, i,
                           args.num_samples if scorer else 1,
                           args.samples_per_batch, args.num_inference_steps)
        best = (scorer.best_of(sample["prompt"],
                               [Image.fromarray(c) for c in cands])
                if scorer else 0)
        Image.fromarray(cands[best]).save(out_path)
        kept[name] = best
        print(f"[{i}/{len(ds)}] {name} -> sample {best}")
    return kept


if __name__ == "__main__":
    main()
