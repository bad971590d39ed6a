"""A synthetic StorySalon-layout dataset (video source), for end-to-end
training and quality runs without the real corpus.

  python -m storygen_tpu_torch.scripts.make_synth_storysalon \\
      --root ./synth_storysalon --stories 4 --frames 7 --test-stories 1

Layout under --root (data/datasets.py::StorySalonDataset's video source):
  image_inpainted_finally_checked/<story>/<i>.png   RGB, --size px
  mask/<story>/<i>.png                              binary
  Text/Caption/Video/<story>/<i>.txt                one caption per frame
  video_test_set.txt                                held-out story ids

Content is procedural (coloured gradients and a disc keyed on story and
frame), enough signal for the loss to move and for windows and refs to
differ. The files are byte for byte those of the JAX package's
scripts/make_synth_storysalon.py with the same flags. Needs PIL.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np


def frame(story: int, i: int, size: int) -> np.ndarray:
    r = np.random.RandomState(story * 1000 + i)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (xx * (1 + story % 3) + i * 0.1)),
        0.5 + 0.5 * np.cos(2 * np.pi * (yy * (1 + story % 2) - i * 0.07)),
        np.clip(xx * 0.5 + yy * 0.5 + 0.1 * r.randn(size, size), 0, 1),
    ], axis=-1)
    cx, cy = int(size * (0.2 + 0.1 * i)), int(size * (0.3 + 0.08 * story))
    rad = size // 8
    m = (yy * size - cy) ** 2 + (xx * size - cx) ** 2 < rad ** 2
    img[m] = [0.9, 0.3 + 0.1 * (i % 3), 0.2]
    return (img * 255).astype(np.uint8)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    tmp = tempfile.gettempdir()  # honours TMPDIR
    ap.add_argument("--root", default=os.path.join(tmp, "synth_storysalon"))
    ap.add_argument("--stories", type=int, default=4)
    ap.add_argument("--frames", type=int, default=7)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--test-stories", type=int, default=1,
                    help="how many trailing stories go to the held-out "
                         "split (video_test_set.txt)")
    return ap.parse_args(argv)


def write(root: str, stories: int, frames: int, size: int = 512,
          test_stories: int = 1) -> None:
    """Write the tree; the last `test_stories` stories are held out."""
    from PIL import Image
    if not 0 < test_stories < stories:
        raise ValueError(f"test_stories {test_stories} must be in "
                         f"[1, stories {stories})")
    img_root = os.path.join(root, "image_inpainted_finally_checked")
    mask_root = os.path.join(root, "mask")
    txt_root = os.path.join(root, "Text", "Caption", "Video")
    for s in range(stories):
        sid = f"synth{s:03d}"
        for d in (os.path.join(img_root, sid), os.path.join(mask_root, sid),
                  os.path.join(txt_root, sid)):
            os.makedirs(d, exist_ok=True)
        for i in range(frames):
            Image.fromarray(frame(s, i, size)).save(
                os.path.join(img_root, sid, f"{i}.png"))
            m = np.full((size, size), 255, np.uint8)
            m[: size // 10] = 0  # top band "text" region
            Image.fromarray(m).save(os.path.join(mask_root, sid, f"{i}.png"))
            with open(os.path.join(txt_root, sid, f"{i}.txt"), "w") as f:
                f.write(f"synthetic story {s} frame {i}: a red circle "
                        f"moves across a gradient field\n")
    with open(os.path.join(root, "video_test_set.txt"), "w") as f:
        for s in range(stories - test_stories, stories):
            f.write(f"synth{s:03d}\n")
    print(f"wrote {stories} stories x {frames} frames at {size}px under "
          f"{root} ({test_stories} held out)")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    write(args.root, args.stories, args.frames, args.size, args.test_stories)


if __name__ == "__main__":
    main()
