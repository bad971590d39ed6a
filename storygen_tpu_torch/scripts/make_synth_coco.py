"""A synthetic COCO-2017-layout dataset (images, instance polygons and
captions), for COCO-stage training and COCO-val runs without the real
corpus.

  python -m storygen_tpu_torch.scripts.make_synth_coco \\
      --root ./synth_coco --images 12

Layout (data/datasets.py::COCOMultiSegDataset):
  train2017/<id>.jpg
  annotations/instances_train2017.json  (images, annotations, categories)
  annotations/captions_train2017.json
`--split val2017` writes val2017/ and the *_val2017.json files instead
(COCOValMultiSegDataset's layout) with the same content. With the default
split the files are byte for byte those of the JAX package's
scripts/make_synth_coco.py with the same flags. Needs PIL.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    tmp = tempfile.gettempdir()  # honours TMPDIR
    ap.add_argument("--root", default=os.path.join(tmp, "synth_coco"))
    ap.add_argument("--images", type=int, default=12)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--split", default="train2017",
                    choices=["train2017", "val2017"])
    return ap.parse_args(argv)


def write(root: str, images: int = 12, size: int = 512,
          split: str = "train2017") -> None:
    from PIL import Image
    os.makedirs(os.path.join(root, split), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cats = [{"id": 1, "name": "person"}, {"id": 2, "name": "dog"},
            {"id": 3, "name": "car"}]
    infos, anns, caps = [], [], []
    s = size
    for i in range(images):
        r = np.random.RandomState(i)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = np.stack([0.4 + 0.4 * np.sin(6 * xx + i),
                        0.4 + 0.4 * np.cos(5 * yy - i),
                        0.3 + 0.2 * r.rand(s, s)], -1)
        name = f"{i:012d}.jpg"
        # 1-3 coloured rectangles, the entities, with polygon segmentations
        n_ent = 1 + i % 3
        for j in range(n_ent):
            x0, y0 = r.randint(0, s // 2, 2)
            w, h = r.randint(s // 8, s // 3, 2)
            x1, y1 = min(x0 + w, s - 1), min(y0 + h, s - 1)
            img[y0:y1, x0:x1] = [0.8, 0.2 + 0.2 * j, 0.1 * j]
            anns.append({"image_id": i, "category_id": cats[j]["id"],
                         "segmentation": [[float(x0), float(y0),
                                           float(x1), float(y0),
                                           float(x1), float(y1),
                                           float(x0), float(y1)]]})
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, split, name), quality=92)
        infos.append({"id": i, "file_name": name, "height": s, "width": s})
        caps.append({"image_id": i,
                     "caption": f"synthetic scene {i} with {n_ent} shapes"})
    with open(os.path.join(root, "annotations",
                           f"instances_{split}.json"), "w") as f:
        json.dump({"images": infos, "annotations": anns,
                   "categories": cats}, f)
    with open(os.path.join(root, "annotations",
                           f"captions_{split}.json"), "w") as f:
        json.dump({"annotations": caps}, f)
    print(f"wrote {images} images at {s}px under {root}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    write(args.root, args.images, args.size, args.split)


if __name__ == "__main__":
    main()
