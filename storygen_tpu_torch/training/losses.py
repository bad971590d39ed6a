"""Training losses.

Counterpart of storygen_tpu/training/losses.py: the masked noise-prediction
MSE. StorySalon images are inpainted where people and text were removed,
and the loss leaves those regions out: mse(pred * (1 - m), noise * (1 - m))
with the mask bilinearly downsampled 8x to the latent grid and broadcast
over the 4 latent channels (reference train_StorySalon_stage2.py:268-270,
325). COCO training uses the unmasked loss.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def downsample_mask(mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """(B, H, W, 1) -> (B, H/f, W/f, 1), bilinear with half-pixel centres
    and no antialiasing (F.interpolate(scale_factor=1/f), as the reference
    computes it), in fp32."""
    b, h, w, _ = mask.shape
    x = mask.float().permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(h // factor, w // factor), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               latent_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error in fp32 over the latent pixels; latent_mask
    (B, h, w, 1) in [0, 1], 1 = excluded (inpainted) region."""
    pred, target = pred.float(), target.float()
    if latent_mask is None:
        return torch.mean((pred - target) ** 2)
    keep = 1.0 - latent_mask.float()
    return torch.mean((pred * keep - target * keep) ** 2)
