"""Person and text masks, and the person-area frame filter. Counterpart of
storygen_tpu/data_process/masking.py.

Detected person and text boxes are rasterized into one uint8 {0, 255}
mask (the regions to inpaint away); a frame whose person boxes cover more
than 0.2 of it is rejected. Detectors are callables
(data_process/detectors.py):
  person_detector(image HWC uint8 RGB) -> [(x1, y1, x2, y2), ...]
  text_detector(image)                 -> [(x1, y1, x2, y2), ...]
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

Box = Tuple[float, float, float, float]


def boxes_to_mask(shape: Tuple[int, int], boxes: Sequence[Box],
                  pad: int = 0) -> np.ndarray:
    """Rasterize boxes into a uint8 {0,255} mask (mask marks regions to
    inpaint away)."""
    mask = np.zeros(shape, dtype=np.uint8)
    h, w = shape
    for x1, y1, x2, y2 in boxes:
        x1 = max(int(x1) - pad, 0)
        y1 = max(int(y1) - pad, 0)
        x2 = min(int(np.ceil(x2)) + pad, w)
        y2 = min(int(np.ceil(y2)) + pad, h)
        mask[y1:y2, x1:x2] = 255
    return mask


def person_area_ratio(shape: Tuple[int, int],
                      person_boxes: Sequence[Box]) -> float:
    m = boxes_to_mask(shape, person_boxes)
    return float((m > 0).mean())


def build_frame_mask(image: np.ndarray,
                     person_detector: Optional[Callable] = None,
                     text_detector: Optional[Callable] = None,
                     max_person_ratio: float = 0.2
                     ) -> Optional[np.ndarray]:
    """Person + text mask of one frame; None if the frame is rejected
    (person area ratio > max_person_ratio)."""
    h, w = image.shape[:2]
    person_boxes = person_detector(image) if person_detector else []
    if person_area_ratio((h, w), person_boxes) > max_person_ratio:
        return None
    text_boxes = text_detector(image) if text_detector else []
    return boxes_to_mask((h, w), list(person_boxes) + list(text_boxes))


def process_directory(image_dir: str, mask_dir: str,
                      person_detector: Optional[Callable] = None,
                      text_detector: Optional[Callable] = None,
                      max_person_ratio: float = 0.2,
                      delete_rejected: bool = False) -> List[str]:
    """Walk a frame directory, writing <stem>.png masks into mask_dir;
    returns the kept frames' paths (rejected ones are deleted when
    delete_rejected)."""
    from PIL import Image
    os.makedirs(mask_dir, exist_ok=True)
    kept = []
    for name in sorted(os.listdir(image_dir)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        p = os.path.join(image_dir, name)
        img = np.asarray(Image.open(p).convert("RGB"))
        mask = build_frame_mask(img, person_detector, text_detector,
                                max_person_ratio)
        if mask is None:
            if delete_rejected:
                os.remove(p)
            continue
        Image.fromarray(mask).save(
            os.path.join(mask_dir, os.path.splitext(name)[0] + ".png"))
        kept.append(p)
    return kept
