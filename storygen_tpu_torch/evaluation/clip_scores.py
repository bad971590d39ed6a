"""CLIP-I / CLIP-T / PickScore on the port's own CLIP towers.

Counterpart of storygen_tpu/evaluation/clip_scores.py, whose scorers run
transformers' CLIPModel: here a transformers CLIP folder loads into the
port's CLIPModel (checkpoint/hf_import.py::load_clip_model), images go
through CLIPImageProcessor's steps (evaluation/preprocess.py) and text
through the port's CLIP BPE tokenizer (truncated at 77, padded to the
batch's longest with its attention mask). Everything runs in fp32 on
`device` (None: the card; the CPU only when asked for).
- CLIP-I: generated-image <-> ground-truth-image cosine similarity.
- CLIP-T: generated-image <-> caption similarity, with the caption path
  found across the StorySalon video and PDF sources.
- PickScore: logit_scale.exp() * the text <-> image cosine, per image,
  and the argmax re-ranking of COCO-val's candidates.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from storygen_tpu_torch.checkpoint.hf_import import load_clip_model
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.evaluation.preprocess import ImageProcessor
from storygen_tpu_torch.utils.device import resolve_device


class _Towers:
    """A CLIP folder's model, image processor and tokenizer on a device."""

    def __init__(self, processor_path: str, model_path: str, device=None):
        self.device = resolve_device(device)
        self.model = load_clip_model(model_path, self.device)
        self.processor = ImageProcessor.from_folder(processor_path)
        self.tokenizer = Tokenizer(processor_path)

    @torch.no_grad()
    def image_features(self, images: Sequence) -> torch.Tensor:
        pixels = torch.from_numpy(self.processor(list(images)))
        return self.model.get_image_features(pixels.to(self.device))

    def text_inputs(self, texts: Sequence[str]):
        """(B, S) ids and attention mask, S the longest of the batch."""
        tok = self.tokenizer
        n = tok.max_length
        rows = [[tok.ids["bos_token"]] + tok.encode(t)[:n - 2]
                + [tok.ids["eos_token"]] for t in texts]
        s = max(len(r) for r in rows)
        ids = np.full((len(rows), s), tok.ids["pad_token"], np.int64)
        mask = np.zeros((len(rows), s), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    @torch.no_grad()
    def text_features(self, texts: Sequence[str]) -> torch.Tensor:
        return self.model.get_text_features(*self.text_inputs(texts))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


class CLIPScorer(_Towers):
    """Image and text embeddings of a local CLIP folder (model, tokenizer
    and preprocessor_config.json in one folder)."""

    def __init__(self, model_path: str, device=None):
        super().__init__(model_path, model_path, device)

    def image_embed(self, images: Sequence) -> np.ndarray:
        """L2-normalised image features (B, D)."""
        return _unit(self.image_features(images)).cpu().numpy()

    def text_embed(self, texts: Sequence[str]) -> np.ndarray:
        """L2-normalised text features (B, D)."""
        return _unit(self.text_features(texts)).cpu().numpy()


def clip_i(scorer: CLIPScorer, gen_images: Sequence,
           gt_images: Sequence) -> float:
    """Mean cosine similarity generated <-> ground-truth images."""
    a = scorer.image_embed(gen_images)
    b = scorer.image_embed(gt_images)
    return float(np.mean(np.sum(a * b, axis=-1)))


def clip_t(scorer: CLIPScorer, gen_images: Sequence,
           captions: Sequence[str]) -> float:
    """Mean cosine similarity generated images <-> their captions."""
    a = scorer.image_embed(gen_images)
    b = scorer.text_embed(captions)
    return float(np.mean(np.sum(a * b, axis=-1)))


def resolve_caption_path(image_path: str, storysalon_root: str
                         ) -> Optional[str]:
    """The StorySalon caption file of a result image named
    <story>_<frame>.png: the video source's, else each PDF source's."""
    stem = os.path.splitext(os.path.basename(image_path))[0]
    parts = stem.split("_")
    candidates = []
    if len(parts) >= 2:
        story, frame = parts[0], "_".join(parts[1:])
        candidates.append(os.path.join(storysalon_root, "Text", "Caption",
                                       "Video", story, frame + ".txt"))
        for src in ("African", "Bloom", "Book", "Digital", "Literacy",
                    "StoryWeaver"):
            candidates.append(os.path.join(storysalon_root, "Text",
                                           "Caption", src, story,
                                           frame + ".txt"))
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


class PickScorer(_Towers):
    """The PickScore_v1 reward: a CLIP folder (CLIP-H + its reward head's
    projections) and the processor folder of its tokenizer and image
    preprocessing."""

    def __init__(self, processor_path: str, model_path: str, device=None):
        super().__init__(processor_path, model_path, device)

    @torch.no_grad()
    def score(self, prompt: str, images: Sequence) -> np.ndarray:
        """Per-image PickScore logits for one prompt."""
        ie = _unit(self.image_features(images))
        te = _unit(self.text_features([prompt]))
        return (self.model.logit_scale.exp() * (te @ ie.T)[0]).cpu().numpy()

    def best_of(self, prompt: str, images: Sequence) -> int:
        """The index of the highest-scoring image."""
        return int(np.argmax(self.score(prompt, images)))


def evaluate_directory(gen_dir: str, gt_dir: str, clip_model_path: str,
                       storysalon_root: Optional[str] = None,
                       device=None) -> dict:
    """CLIP-I of the generated images against the same names in gt_dir,
    and CLIP-T against their StorySalon captions."""
    from PIL import Image
    scorer = CLIPScorer(clip_model_path, device)
    names = sorted(n for n in os.listdir(gen_dir)
                   if n.lower().endswith((".png", ".jpg")))
    gen = [Image.open(os.path.join(gen_dir, n)).convert("RGB")
           for n in names]
    out = {}
    gt_names = [n for n in names if os.path.exists(os.path.join(gt_dir, n))]
    if gt_names:
        gt = [Image.open(os.path.join(gt_dir, n)).convert("RGB")
              for n in gt_names]
        gen_matched = [Image.open(os.path.join(gen_dir, n)).convert("RGB")
                       for n in gt_names]
        out["clip_i"] = clip_i(scorer, gen_matched, gt)
    if storysalon_root:
        caps, imgs = [], []
        for n, im in zip(names, gen):
            p = resolve_caption_path(n, storysalon_root)
            if p:
                with open(p) as f:
                    caps.append(f.read().strip())
                imgs.append(im)
        if caps:
            out["clip_t"] = clip_t(scorer, imgs, caps)
    return out
