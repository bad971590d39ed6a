"""Images to CLIP pixel values, as transformers' CLIPImageProcessor
makes them, read from a folder's preprocessor_config.json: RGB, a PIL
resize of the shortest edge (the long side int(s * long / short)), a
centre crop, x rescale_factor (1/255) and normalisation by image_mean /
image_std (CLIP's by default). A config that turns one of these steps off
or sizes the resize by height and width raises. Needs PIL."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
PIL_BICUBIC = 3
STEPS = ("do_resize", "do_center_crop", "do_rescale", "do_normalize",
         "do_convert_rgb")


@dataclass(frozen=True)
class ImageProcessor:
    shortest_edge: int = 224
    crop_hw: Tuple[int, int] = (224, 224)
    resample: int = PIL_BICUBIC
    rescale_factor: float = 1 / 255
    image_mean: Tuple[float, ...] = OPENAI_CLIP_MEAN
    image_std: Tuple[float, ...] = OPENAI_CLIP_STD

    @classmethod
    def from_folder(cls, folder: str) -> "ImageProcessor":
        """The folder's preprocessor_config.json, CLIPImageProcessor's
        defaults where it is silent."""
        with open(os.path.join(folder, "preprocessor_config.json")) as f:
            d = json.load(f)
        off = [k for k in STEPS if d.get(k, True) is not True]
        size = d.get("size", 224)
        edge = size if isinstance(size, int) else size.get("shortest_edge")
        if off or edge is None:
            raise ValueError(f"unsupported preprocessor_config.json in "
                             f"{folder}: steps off {off}, size {size}")
        crop = d.get("crop_size", 224)
        kw = {k: d[k] for k in ("resample", "rescale_factor") if k in d}
        for k in ("image_mean", "image_std"):
            if d.get(k) is not None:
                kw[k] = tuple(d[k])
        return cls(shortest_edge=edge,
                   crop_hw=((crop, crop) if isinstance(crop, int)
                            else (crop["height"], crop["width"])), **kw)

    def resize(self, image):
        """A PIL image resized as CLIPImageProcessor.resize does."""
        w, h = image.size
        s = self.shortest_edge
        short, long = (w, h) if w <= h else (h, w)
        new_long = int(s * long / short)
        size = (s, new_long) if w <= h else (new_long, s)
        return image.resize(size, resample=self.resample, reducing_gap=None)

    def __call__(self, images: Sequence) -> np.ndarray:
        """PIL images (or uint8 HWC arrays) -> (B, 3, H, W) float32."""
        from PIL import Image
        out = []
        ch, cw = self.crop_hw
        for image in images:
            if not isinstance(image, Image.Image):
                image = Image.fromarray(np.asarray(image))
            if image.mode != "RGB":
                image = image.convert("RGB")
            x = np.asarray(self.resize(image))
            top = (x.shape[0] - ch) // 2
            left = (x.shape[1] - cw) // 2
            if top < 0 or left < 0:
                raise ValueError(f"image {x.shape[:2]} smaller than the "
                                 f"crop {self.crop_hw}")
            x = x[top:top + ch, left:left + cw]
            x = (x.astype(np.float64) * self.rescale_factor).astype(
                np.float32)
            x = ((x - np.asarray(self.image_mean, np.float32))
                 / np.asarray(self.image_std, np.float32))
            out.append(x.transpose(2, 0, 1))
        return np.stack(out)
