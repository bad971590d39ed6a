"""Keyframe and subtitle extraction, host code. Counterpart of
storygen_tpu/data_process/extract.py.

- Keyframes: I-frame indices from ffprobe when the binary exists, else
  shot changes detected in the decoded frames (mean absolute difference
  of 64x64 thumbnails over a stride), grabbed with cv2 and saved as
  timestamped PNGs.
- Subtitles: VTT cleanup: strip inline tags, drop headers and cue
  settings, merge consecutive duplicate lines and their timestamps.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import List, Optional, Sequence, Tuple


# --------------------------------------------------------------- keyframes

def ffprobe_keyframe_indices(video_path: str) -> List[int]:
    """Frame indices of I-frames via ffprobe (needs ffmpeg)."""
    out = subprocess.run(
        ["ffprobe", "-select_streams", "v", "-show_frames",
         "-show_entries", "frame=pict_type", "-of", "csv", video_path],
        capture_output=True, text=True, check=True).stdout
    return [i for i, line in enumerate(out.splitlines())
            if line.rstrip().endswith(",I")]


def diff_keyframe_indices(video_path: str, threshold: float = 18.0,
                          stride: int = 5, min_gap: int = 15) -> List[int]:
    """Shot-change detection by mean abs frame difference (no ffmpeg)."""
    import cv2
    import numpy as np
    cap = cv2.VideoCapture(video_path)
    idx, prev, keys, last_key = 0, None, [0], 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            small = cv2.resize(frame, (64, 64)).astype("float32")
            if prev is not None:
                if (abs(small - prev).mean() > threshold
                        and idx - last_key >= min_gap):
                    keys.append(idx)
                    last_key = idx
            prev = small
        idx += 1
    cap.release()
    return keys


def extract_keyframes(video_path: str, out_dir: str,
                      timestamps: bool = True) -> List[str]:
    """Save keyframes as <index>_<h:mm:ss>.png (or <index:05d>.png)."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    if shutil.which("ffprobe"):
        keys = ffprobe_keyframe_indices(video_path)
    else:
        keys = diff_keyframe_indices(video_path)
    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    paths = []
    for n, k in enumerate(keys):
        cap.set(cv2.CAP_PROP_POS_FRAMES, k)
        ok, frame = cap.read()
        if not ok:
            continue
        secs = int(k / fps)
        stamp = f"{secs // 3600}:{(secs % 3600) // 60:02d}:{secs % 60:02d}"
        name = f"{n}_{stamp}.png" if timestamps else f"{n:05d}.png"
        p = os.path.join(out_dir, name)
        cv2.imwrite(p, frame)
        paths.append(p)
    cap.release()
    return paths


# --------------------------------------------------------------- subtitles

_TAG = re.compile(r"<[^>]+>")
_TIMESTAMP = re.compile(r"(\d+:)?\d{2}:\d{2}[.,]\d{3}")


def remove_tags(line: str) -> str:
    """Strip inline VTT tags like <c> and <00:00:01.000>."""
    return _TAG.sub("", line).strip()


def is_header(line: str) -> bool:
    s = line.strip()
    return (s.startswith(("WEBVTT", "Kind:", "Language:", "NOTE", "STYLE"))
            or s == "")


def parse_vtt(text: str) -> List[Tuple[str, str, str]]:
    """-> [(start, end, text)] cues with tags removed."""
    cues = []
    cur: Optional[Tuple[str, str]] = None
    lines_acc: List[str] = []
    for raw in text.splitlines():
        if is_header(raw):
            continue
        m = re.match(r"\s*([\d:.,]+)\s*-->\s*([\d:.,]+)", raw)
        if m:
            if cur and lines_acc:
                cues.append((cur[0], cur[1], " ".join(lines_acc)))
            cur = (m.group(1), m.group(2))
            lines_acc = []
        elif cur is not None:
            t = remove_tags(raw)
            if t:
                lines_acc.append(t)
    if cur and lines_acc:
        cues.append((cur[0], cur[1], " ".join(lines_acc)))
    return cues


def merge_duplicates(cues: Sequence[Tuple[str, str, str]]
                     ) -> List[Tuple[str, str, str]]:
    """Merge consecutive cues with identical text, widening the timestamp
    span."""
    out: List[Tuple[str, str, str]] = []
    for start, end, text in cues:
        if out and out[-1][2] == text:
            out[-1] = (out[-1][0], end, text)
        else:
            out.append((start, end, text))
    return out


def clean_vtt(text: str) -> List[Tuple[str, str, str]]:
    """Full cleanup chain: parse -> dedup-merge."""
    return merge_duplicates(parse_vtt(text))


def vtt_to_transcript(text: str) -> str:
    """All subtitle text joined (the input of align.py's sentence
    split)."""
    return " ".join(t for _, _, t in clean_vtt(text))
