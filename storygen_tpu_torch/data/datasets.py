"""Training datasets that need no image decoder.

Counterpart of storygen_tpu/data/datasets.py's PrecomputedLatentDataset.
The StorySalon and COCO datasets decode images with PIL and are not
ported.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


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
