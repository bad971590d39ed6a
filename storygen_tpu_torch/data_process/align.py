"""Frame <-> sentence alignment by dynamic time warping, host code.
Counterpart of storygen_tpu/data_process/align.py.

Restore punctuation, split the transcript into sentences, embed the
frames (the embedding of a frame's OCR text when OCR finds some, else its
image embedding), then align over cost = cosine distance + a time
penalty, giving a frame -> sentences map. The embedders, the OCR and the
punctuation model are callables; inputs and outputs are numpy.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def split_sentences(text: str) -> List[str]:
    """Sentence split on terminal punctuation."""
    parts = re.split(r"(?<=[.!?])\s+", text.strip())
    return [p.strip() for p in parts if p.strip()]


def _norm_rows(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def dtw_align(frame_emb: np.ndarray, sent_emb: np.ndarray,
              frame_times: Optional[np.ndarray] = None,
              time_penalty: float = 0.1) -> List[Tuple[int, int]]:
    """Monotonic frame<->sentence alignment path.

    cost[i, j] = cosine distance(frame i, sentence j)
               + time_penalty * |i/(N-1) - j/(M-1)|
    Moves: advance frame, advance sentence, or both (classic DTW).
    Returns [(frame_idx, sent_idx)] pairs along the optimal path.
    """
    f = _norm_rows(np.asarray(frame_emb, np.float64))
    s = _norm_rows(np.asarray(sent_emb, np.float64))
    n, m = len(f), len(s)
    if n == 0 or m == 0:
        return []
    cost = 1.0 - f @ s.T
    pos_f = (frame_times / max(frame_times[-1], 1e-9)
             if frame_times is not None
             else np.arange(n) / max(n - 1, 1))
    pos_s = np.arange(m) / max(m - 1, 1)
    cost = cost + time_penalty * np.abs(pos_f[:, None] - pos_s[None, :])

    acc = np.full((n, m), np.inf)
    acc[0, 0] = cost[0, 0]
    for i in range(n):
        for j in range(m):
            if i == 0 and j == 0:
                continue
            best = np.inf
            if i > 0:
                best = min(best, acc[i - 1, j])
            if j > 0:
                best = min(best, acc[i, j - 1])
            if i > 0 and j > 0:
                best = min(best, acc[i - 1, j - 1])
            acc[i, j] = cost[i, j] + best

    # backtrack
    path = [(n - 1, m - 1)]
    i, j = n - 1, m - 1
    while i > 0 or j > 0:
        cands = []
        if i > 0 and j > 0:
            cands.append((acc[i - 1, j - 1], (i - 1, j - 1)))
        if i > 0:
            cands.append((acc[i - 1, j], (i - 1, j)))
        if j > 0:
            cands.append((acc[i, j - 1], (i, j - 1)))
        _, (i, j) = min(cands, key=lambda c: c[0])
        path.append((i, j))
    return path[::-1]


def frames_to_sentences(path: Sequence[Tuple[int, int]],
                        num_frames: int) -> Dict[int, List[int]]:
    """frame index -> sorted sentence indices."""
    out: Dict[int, List[int]] = {i: [] for i in range(num_frames)}
    for fi, sj in path:
        out[fi].append(sj)
    return {k: sorted(set(v)) for k, v in out.items()}


def align_story(frame_images: Sequence[np.ndarray], transcript: str,
                image_embed: Callable, text_embed: Callable,
                ocr: Optional[Callable] = None,
                punctuate: Optional[Callable] = None,
                time_penalty: float = 0.1) -> Dict[int, List[str]]:
    """Full alignment: returns frame index -> list of sentences.

    image_embed: (B, H, W, 3)->(B, D); text_embed: list[str]->(B, D);
    ocr: image->str or None; punctuate: str->str (restoration model).
    Frame feature = OCR-text embedding when OCR finds text, else the image
    embedding.
    """
    if punctuate is not None:
        transcript = punctuate(transcript)
    sentences = split_sentences(transcript)
    if not sentences or not len(frame_images):
        return {}
    sent_emb = np.asarray(text_embed(sentences))

    feats = []
    img_emb = np.asarray(image_embed(np.stack(frame_images)))
    for i, img in enumerate(frame_images):
        txt = ocr(img) if ocr is not None else None
        if txt:
            feats.append(np.asarray(text_embed([txt]))[0])
        else:
            feats.append(img_emb[i])
    path = dtw_align(np.stack(feats), sent_emb,
                     time_penalty=time_penalty)
    idx_map = frames_to_sentences(path, len(frame_images))
    return {i: [sentences[j] for j in js] for i, js in idx_map.items()}
