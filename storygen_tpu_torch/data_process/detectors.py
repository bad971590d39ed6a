"""Detector backends of the masking stage. Counterpart of
storygen_tpu/data_process/detectors.py, in the same order of choice:

  text:   easyocr when it imports -> the classical detector (gradient +
          morphology + contour filtering; no weights).
  person: the port's YOLOv7 (detection/yolov7.py) on the card, fed by
          yolov7.pt or any state_dict export of it -> YOLO via a
          TorchScript file or torch.hub's cached yolov5 packaging -> cv2's
          FaceDetectorYN when an ONNX file is given -> None (text-only
          masks).

A person detector that cannot read its weights file gives way to the next
one; one that needs the card refuses to run without it (device=None means
the card).

All detectors share one contract:
  detector(image HWC uint8 RGB) -> [(x1, y1, x2, y2), ...]
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, List, Optional, Tuple

import numpy as np

Box = Tuple[float, float, float, float]
# what reading a weights file that is not a YOLOv7 checkpoint (or not a
# TorchScript file) can raise
UNREADABLE = (OSError, EOFError, RuntimeError, ValueError, KeyError,
              pickle.UnpicklingError)
# torch.hub's cache folder of the ultralytics/yolov5 repository
YOLOV5_REPO = "ultralytics_yolov5_master"


# ------------------------------------------------------------------ text
def classical_text_detector(min_height: int = 8,
                            max_height_frac: float = 0.25,
                            min_aspect: float = 1.1,
                            min_fill: float = 0.25,
                            connect_width: int = 15) -> Callable:
    """Weights-free text-region detector for overlay text (subtitles,
    scene text): morphological gradient -> Otsu binarize -> horizontal
    close (connects characters into line blobs) -> contour boxes filtered
    by height, aspect ratio and ink density."""
    import cv2

    def detect(image: np.ndarray) -> List[Box]:
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) \
            if image.ndim == 3 else image
        h, w = gray.shape
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
        grad = cv2.morphologyEx(gray, cv2.MORPH_GRADIENT, kernel)
        _, bw = cv2.threshold(grad, 0, 255,
                              cv2.THRESH_BINARY | cv2.THRESH_OTSU)
        connect = cv2.getStructuringElement(cv2.MORPH_RECT,
                                            (connect_width, 1))
        closed = cv2.morphologyEx(bw, cv2.MORPH_CLOSE, connect)
        contours, _ = cv2.findContours(closed, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        boxes: List[Box] = []
        for c in contours:
            x, y, bw_, bh = cv2.boundingRect(c)
            if bh < min_height or bh > h * max_height_frac:
                continue
            if bw_ < min_aspect * bh:
                continue
            patch = bw[y:y + bh, x:x + bw_]
            if float((patch > 0).mean()) < min_fill:
                continue
            boxes.append((float(x), float(y), float(x + bw_),
                          float(y + bh)))
        return boxes

    return detect


def easyocr_text_detector(langs=("en",), conf: float = 0.3
                          ) -> Optional[Callable]:
    """OCR boxes scoring at least `conf`; None when easyocr does not
    import."""
    try:
        import easyocr
    except ImportError:
        return None
    reader = easyocr.Reader(list(langs))

    def detect(image: np.ndarray) -> List[Box]:
        boxes: List[Box] = []
        for quad, _text, score in reader.readtext(np.asarray(image)):
            if score < conf:
                continue
            xs = [p[0] for p in quad]
            ys = [p[1] for p in quad]
            boxes.append((min(xs), min(ys), max(xs), max(ys)))
        return boxes

    return detect


def default_text_detector() -> Callable:
    return easyocr_text_detector() or classical_text_detector()


# ---------------------------------------------------------------- person
def yolov7_person_detector(weights: str, conf: float = 0.5,
                           device=None) -> Optional[Callable]:
    """The port's YOLOv7 (detection/yolov7.py) on `device` (None: the
    card; without one this raises). None when the weights file is absent
    or is not a YOLOv7 checkpoint."""
    if not (weights and os.path.exists(weights)):
        return None
    from storygen_tpu_torch.detection import yolov7
    from storygen_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    try:
        state = yolov7.import_yolov7_params(yolov7.load_torch_state(weights))
    except UNREADABLE:
        return None
    return yolov7.yolov7_person_detector(state, conf=conf, device=device)


def yolo_person_detector(weights: Optional[str] = None, conf: float = 0.5,
                         device=None) -> Optional[Callable]:
    """YOLO person boxes (class 0) from a TorchScript file, or through
    torch.hub's yolov5 packaging when its repository is in torch.hub's
    cache (nothing is fetched), on `device` (None: the card); None when
    nothing loads."""
    if not (weights and os.path.exists(weights)):
        return None
    import torch
    from storygen_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    try:
        model = torch.jit.load(weights, map_location=device)
    except UNREADABLE:
        hub_repo = os.path.join(torch.hub.get_dir(), YOLOV5_REPO)
        if not os.path.isdir(hub_repo):
            return None
        try:
            model = torch.hub.load(hub_repo, "custom", path=weights,
                                   source="local")
        except (ImportError, *UNREADABLE):
            return None
        model = model.to(device)
    model.eval()

    def detect(image: np.ndarray) -> List[Box]:
        with torch.no_grad():
            res = model(np.asarray(image))
        det = res.xyxy[0].cpu().numpy() if hasattr(res, "xyxy") else \
            np.asarray(res[0].cpu() if torch.is_tensor(res[0]) else res[0])
        boxes = []
        for row in det:
            x1, y1, x2, y2, score, cls = row[:6]
            if int(cls) == 0 and score >= conf:
                boxes.append((float(x1), float(y1), float(x2), float(y2)))
        return boxes

    return detect


def face_person_detector(onnx_path: str, conf: float = 0.7,
                         expand: float = 0.35) -> Optional[Callable]:
    """cv2.FaceDetectorYN boxes, widened by `expand` on each side, in
    place of person boxes when no YOLO weights exist (the regions to
    inpaint away are presenters' faces and hands). Host code."""
    import cv2
    if not (hasattr(cv2, "FaceDetectorYN_create")
            and os.path.exists(onnx_path)):
        return None
    det = cv2.FaceDetectorYN_create(onnx_path, "", (320, 320), conf)

    def detect(image: np.ndarray) -> List[Box]:
        h, w = image.shape[:2]
        det.setInputSize((w, h))
        _, faces = det.detect(
            np.ascontiguousarray(image[..., ::-1]))  # RGB -> BGR
        boxes: List[Box] = []
        if faces is None:
            return boxes
        for f in faces:
            x, y, bw, bh = f[:4]
            dx, dy = bw * expand, bh * expand
            boxes.append((max(x - dx, 0), max(y - dy, 0),
                          min(x + bw + dx, w), min(y + bh + dy, h)))
        return boxes

    return detect


def default_person_detector(yolo_weights: Optional[str] = None,
                            face_onnx: Optional[str] = None,
                            device=None) -> Optional[Callable]:
    """The port's YOLOv7 -> TorchScript / torch.hub YOLO -> the face
    detector -> None (text-only masks)."""
    det = None
    if yolo_weights:
        det = yolov7_person_detector(yolo_weights, device=device)
        det = det or yolo_person_detector(weights=yolo_weights,
                                          device=device)
    if det is None and face_onnx:
        det = face_person_detector(face_onnx)
    return det
