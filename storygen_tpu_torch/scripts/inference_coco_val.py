"""Renders for COCO val2017: one image per val image, in
"multi-image-condition" with its segment crops as refs.

  python -m storygen_tpu_torch.scripts.inference_coco_val \\
      --ckpt <folder> --coco_root ./coco --logdir ./coco_val_out

Image i is rendered once, with the draws of `seeded_draws(device,
1000 * i)`: what the JAX script keeps without a scorer, or with
`--num_samples 1`. Its PickScore re-ranking of several candidates is not
ported, nor are the flags that only serve it (`--num_samples`,
`--samples_per_batch`, `--pickscore_*`). An image whose output exists is
skipped. Needs PIL and cv2 (the COCO dataset), and PIL writes the output
under the val image's own file name.
"""
from __future__ import annotations

import argparse
import functools
import os
from typing import Optional, Sequence

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
    ap.add_argument("--num_inference_steps", type=int, default=40)
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from PIL import Image
    pipe = load_pipeline(args.ckpt, args.device)
    ds = COCOValMultiSegDataset(args.coco_root, caption_dir=args.caption_dir)
    os.makedirs(args.logdir, exist_ok=True)
    for i in range(len(ds)):
        sample = ds[i]
        name = os.path.basename(sample["image_path"])
        out_path = os.path.join(args.logdir, name)
        if os.path.exists(out_path):
            continue
        out = pipe(stage="multi-image-condition",
                   prompt=[sample["prompt"]],
                   image_prompt=sample["ref_images"][:, None],
                   prev_prompt=[[p] for p in sample["ref_prompts"]],
                   num_inference_steps=args.num_inference_steps,
                   draw=functools.partial(seeded_draws(pipe.device, 1000 * i),
                                          0))
        Image.fromarray((out[0] * 255).astype(np.uint8)).save(out_path)
        print(f"[{i}/{len(ds)}] {name}")


if __name__ == "__main__":
    main()
