"""Training and validation datasets: HWC float32 numpy samples.

Counterpart of storygen_tpu/data/datasets.py, sample for sample:
- SimpleDataset: image / mask / text triples under root/{image,mask,text};
- StorySalonDataset: the six PDF sources and the video source, sliding
  windows of 4 frames (3 refs + 1 target), the train / test split from
  PDF_test_set.txt and video_test_set.txt, CFG dropout (5% empty prompt,
  10% zeroed refs with empty ref prompts) on a per-item RNG;
- COCOMultiSegDataset / COCOValMultiSegDataset: up to 3 segment crops of
  the target as refs (extras merged into the third), augmented;
- PrecomputedLatentDataset: the .npz files of
  storygen_tpu_torch/scripts/precompute_latents.py.

Targets are in [-1, 1] and refs in [0, 1] (the reference checkpoints'
convention; `normalize_refs=True` puts refs in [-1, 1] too).

Images are decoded by PIL, imported where it is used. On a host without
PIL, a PNG already `size` x `size` (PIL's resize is then the identity) is
read by utils/image.py's PNG reader, pixel for pixel what PIL gives, and
anything else raises ImportError. The COCO datasets also need cv2,
imported likewise. uint8 pixels become float32 in the native library
(storygen_tpu_torch/native, built by g++ at its first call).
"""
from __future__ import annotations

import json
import os
import random
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from storygen_tpu_torch import native
from storygen_tpu_torch.utils.image import png_size, read_png


def normalize_u8(img: np.ndarray, scale: float, offset: float) -> np.ndarray:
    """uint8 array -> float32 img * scale + offset, by the native library
    (storygen_tpu_torch/native)."""
    return native.normalize_u8(img, scale, offset)


def load_rgb(path: str, size: int = 512) -> np.ndarray:
    """(size, size, 3) uint8: `Image.open(path).convert("RGB").resize(
    (size, size))`. Without PIL, a PNG that is already that size is read
    by read_png (one it cannot decode raises); anything else raises."""
    try:
        from PIL import Image
    except ImportError:
        if path.lower().endswith(".png") and png_size(path) == (size, size):
            return read_png(path)
        raise
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB").resize((size, size)),
                          dtype=np.uint8)


def _load_image(path: str, size: int = 512) -> np.ndarray:
    """RGB HWC float32 in [0, 1]."""
    return normalize_u8(load_rgb(path, size), 1.0 / 255.0, 0.0)


def _load_mask(path: str, size: int = 512) -> np.ndarray:
    """Channel 0 of the RGB mask, HW1 float32 in [0, 1]."""
    return normalize_u8(load_rgb(path, size)[:, :, :1], 1.0 / 255.0, 0.0)


def _read_text(path: str) -> str:
    with open(path) as f:
        return f.read()


class _PerItemRNG:
    """A random.Random per (seed, epoch, item), so that a sample's draws do
    not depend on which loader thread loads it. The DataLoader sets the
    epoch, so dropout varies across epochs."""

    def __init__(self, seed: Optional[int]):
        self.seed = 0 if seed is None else int(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def for_item(self, idx: int) -> random.Random:
        # a str seed hashes the same under any PYTHONHASHSEED
        return random.Random(f"{self.seed}/{self.epoch}/{int(idx)}")


def _natural_key(s: str):
    """Natural sort for video frame names like 12_0:03:04.jpg."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


class SimpleDataset:
    """Tiny image/mask/text dataset over root/{image,mask,text}."""

    def __init__(self, root: str, size: int = 512):
        self.size = size
        names = sorted(os.listdir(os.path.join(root, "image")))
        self.items = [
            (os.path.join(root, "image", n), os.path.join(root, "mask", n),
             os.path.join(root, "text", os.path.splitext(n)[0] + ".txt"))
            for n in names]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        img_p, mask_p, text_p = self.items[idx]
        image = _load_image(img_p, self.size) * 2.0 - 1.0
        mask = _load_mask(mask_p, self.size)
        return {"image": image, "mask": mask, "prompt": _read_text(text_p)}


def _windows(folder: str, key=None) -> List[List[str]]:
    """Every window of 4 consecutive files of a folder (a story of fewer
    than 4 frames gives none)."""
    try:
        names = sorted(os.listdir(folder), key=key)
    except FileNotFoundError:
        return []
    paths = [os.path.join(folder, n) for n in names]
    return [paths[i:i + 4] for i in range(len(paths) - 3)]


PDF_SOURCES = ("African", "Bloom", "Book", "Digital", "Literacy",
               "StoryWeaver")
# the repository's copies of the held-out story ids
REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def _read_ids(root: str, name: str) -> set:
    """Held-out story ids from root/name, else from the repository's
    data/name, else none."""
    for folder in (root, REPO_DATA):
        p = os.path.join(folder, name)
        if os.path.exists(p):
            with open(p) as f:
                return {line.strip() for line in f if line.strip()}
    return set()


class StorySalonDataset:
    """Sliding windows of a story: 3 reference frames + 1 target.

    Layout under `root`:
      Image_inpainted/<Source>/<story_id>/*.png, Mask/<Source>/...,
      Text/Caption/<Source>/... for the six PDF sources;
      image_inpainted_finally_checked/<story_id>/, mask/<story_id>/,
      Text/Caption/Video/<story_id>/ for the video source;
      PDF_test_set.txt, video_test_set.txt (held-out story ids; the
      repository's data/ copies when the root has none).
    """

    def __init__(self, root: str, dataset_name: str = "train",
                 size: int = 512, normalize_refs: bool = False,
                 cfg_dropout: bool = True, seed: Optional[int] = None):
        if dataset_name not in ("train", "test"):
            raise ValueError(f"dataset_name {dataset_name!r}: 'train' or "
                             "'test'")
        self.root = root
        self.dataset_name = dataset_name
        self.size = size
        self.normalize_refs = normalize_refs
        self.cfg_dropout = cfg_dropout and dataset_name == "train"
        self._rng = _PerItemRNG(seed)
        self.samples: List[Tuple[List[str], List[str], List[str]]] = []

        def add_source(img_dir, mask_dir, text_dir, test_ids, sort_key=None):
            if not os.path.isdir(img_dir):
                return
            for story in sorted(os.listdir(img_dir)):
                if (dataset_name == "test") != (story in test_ids):
                    continue
                self.samples.extend(zip(
                    _windows(os.path.join(img_dir, story), sort_key),
                    _windows(os.path.join(mask_dir, story), sort_key),
                    _windows(os.path.join(text_dir, story), sort_key)))

        pdf_test = _read_ids(root, "PDF_test_set.txt")
        for src in PDF_SOURCES:
            add_source(os.path.join(root, "Image_inpainted", src),
                       os.path.join(root, "Mask", src),
                       os.path.join(root, "Text", "Caption", src), pdf_test)
        add_source(os.path.join(root, "image_inpainted_finally_checked"),
                   os.path.join(root, "mask"),
                   os.path.join(root, "Text", "Caption", "Video"),
                   _read_ids(root, "video_test_set.txt"),
                   sort_key=_natural_key)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict:
        img_w, mask_w, text_w = self.samples[idx]
        ref_images = np.stack([_load_image(p, self.size) for p in img_w[:3]])
        image = _load_image(img_w[3], self.size) * 2.0 - 1.0
        mask = _load_mask(mask_w[3], self.size)
        ref_prompts = [_read_text(p) for p in text_w[:3]]
        prompt = _read_text(text_w[3])
        if self.normalize_refs:
            ref_images = ref_images * 2.0 - 1.0
        if self.cfg_dropout:
            rng = self._rng.for_item(idx)
            if rng.uniform(0, 1) < 0.05:
                prompt = ""
            if rng.uniform(0, 1) < 0.1:
                ref_prompts = ["", "", ""]
                ref_images = ref_images * 0.0
        return {"image": image, "ref_images": ref_images, "mask": mask,
                "prompt": prompt, "ref_prompts": ref_prompts}


def _fill_polys(shape, segmentation) -> np.ndarray:
    """uint8 mask (255 inside) of a COCO polygon segmentation."""
    import cv2
    mask = np.zeros(shape, dtype=np.uint8)
    if isinstance(segmentation, list):
        for seg in segmentation:
            if isinstance(seg, list) and len(seg) > 1:
                poly = np.asarray(seg)
                if poly.size >= 4:
                    poly = poly.reshape(-1, 2).astype(np.int32)
                    cv2.fillPoly(mask, [poly], color=255)
    return mask


def _augment(img: np.ndarray, rng: random.Random,
             degrees: float = 30.0, translate: float = 0.2,
             scale_rng: Tuple[float, float] = (0.8, 1.3)) -> np.ndarray:
    """Random affine, colour jitter (brightness, contrast, saturation 0.2)
    and horizontal flip of a [0, 1] HWC image."""
    import cv2
    h, w = img.shape[:2]
    ang = rng.uniform(-degrees, degrees)
    tx = rng.uniform(-translate, translate) * w
    ty = rng.uniform(-translate, translate) * h
    sc = rng.uniform(*scale_rng)
    m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, sc)
    m[:, 2] += (tx, ty)
    img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR)
    img = np.clip(img * rng.uniform(0.8, 1.2), 0, 1)
    mean = img.mean()
    img = np.clip((img - mean) * rng.uniform(0.8, 1.2) + mean, 0, 1)
    gray = img.mean(axis=-1, keepdims=True)
    img = np.clip((img - gray) * rng.uniform(0.8, 1.2) + gray, 0, 1)
    if rng.random() < 0.5:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


class COCOMultiSegDataset:
    """COCO 2017: the target image, and up to 3 of its segments as ref
    crops with their category names as ref prompts."""

    def __init__(self, root: str, size: int = 512, split: str = "train",
                 normalize_refs: bool = False, cfg_dropout: bool = True,
                 augment: bool = True, seed: Optional[int] = None):
        part = "train2017" if split == "train" else "val2017"
        self.image_dir = os.path.join(root, part)
        self.size = size
        self.split = split
        self.normalize_refs = normalize_refs
        self.cfg_dropout = cfg_dropout
        self.augment = augment
        self._rng = _PerItemRNG(seed)
        with open(os.path.join(root, "annotations",
                               f"instances_{part}.json")) as f:
            seg = json.load(f)
        self.images = seg["images"]
        self.categories = {c["id"]: c["name"] for c in seg["categories"]}
        self.anns_by_image: Dict[int, list] = {}
        for a in seg["annotations"]:
            self.anns_by_image.setdefault(a["image_id"], []).append(a)
        cap_path = os.path.join(root, "annotations", f"captions_{part}.json")
        self.caps_by_image: Dict[int, List[str]] = {}
        if os.path.exists(cap_path):
            with open(cap_path) as f:
                for a in json.load(f)["annotations"]:
                    self.caps_by_image.setdefault(
                        a["image_id"], []).append(a["caption"])

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict:
        import cv2
        from PIL import Image
        info = self.images[idx]
        path = os.path.join(self.image_dir, info["file_name"])
        with Image.open(path) as img:
            raw = np.asarray(img.convert("RGB"))

        crops, cats = [], []
        for ann in self.anns_by_image.get(info["id"], []):
            m = _fill_polys(raw.shape[:2], ann["segmentation"])
            crops.append(cv2.bitwise_and(raw, raw, mask=m))
            cats.append(self.categories[ann["category_id"]])
        while len(crops) < 3:
            crops.append(np.zeros_like(raw))
            cats.append("")
        if len(crops) > 3:  # extras merge into the third slot
            merged = crops[2]
            for extra in crops[3:]:
                merged = merged + extra
            crops = crops[:2] + [merged]
            cats = cats[:3]

        rng = self._rng.for_item(idx)
        refs = []
        for c in crops:
            img = np.asarray(Image.fromarray(c.astype(np.uint8)).resize(
                (self.size, self.size)), dtype=np.float32) / 255.0
            if self.augment:
                deg, tr, sc = ((30, 0.2, (0.8, 1.3)) if self.split == "train"
                               else (10, 0.1, (0.9, 1.1)))
                img = _augment(img, rng, deg, tr, sc)
            refs.append(img)
        ref_images = np.stack(refs)
        image = _load_image(path, self.size) * 2.0 - 1.0
        caps = self.caps_by_image.get(info["id"], [])
        prompt = rng.choice(caps) if caps else ""
        if self.normalize_refs:
            ref_images = ref_images * 2.0 - 1.0
        if self.cfg_dropout:
            if rng.uniform(0, 1) < 0.05:
                prompt = ""
            if rng.uniform(0, 1) < 0.1:
                cats = ["", "", ""]
                ref_images = ref_images * 0.0
        return {"image": image, "ref_images": ref_images,
                "prompt": prompt, "ref_prompts": cats}


class COCOValMultiSegDataset(COCOMultiSegDataset):
    """val2017 without dropout, with each sample's image_path and, when a
    caption folder is given, the caption in <caption_dir>/<stem>.txt."""

    def __init__(self, root: str, caption_dir: Optional[str] = None, **kw):
        super().__init__(root, split="val", cfg_dropout=False, **kw)
        self.caption_dir = caption_dir

    def __getitem__(self, idx: int) -> Dict:
        out = super().__getitem__(idx)
        name = self.images[idx]["file_name"]
        out["image_path"] = os.path.join(self.image_dir, name)
        if self.caption_dir:
            p = os.path.join(self.caption_dir,
                             os.path.splitext(name)[0] + ".txt")
            if os.path.exists(p):
                out["prompt"] = _read_text(p)
        return out


class PrecomputedLatentDataset:
    """One item per `<index>.npz` of precomputed VAE posterior moments:
    `latent_moments` (h, w, 8) and `ref_latent_moments` (N, h, w, 8)
    (mean and logvar, stored fp16), `mask` (H, W, 1), `input_ids` (77,)
    and `ref_input_ids` (N, 77). Moments and mask are widened to fp32;
    the train step samples the posterior from them at every step. The
    files hold no CFG dropout: the step applies it."""

    def __init__(self, root: str):
        self.root = root
        self.files = sorted(f for f in os.listdir(root) if f.endswith(".npz"))
        if not self.files:
            raise FileNotFoundError(f"no .npz latent files under {root}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.root, self.files[i])) as z:
            out = {k: z[k] for k in z.files}
        for k in ("latent_moments", "ref_latent_moments", "mask"):
            if k in out:
                out[k] = out[k].astype(np.float32)
        return out
