"""Duplicate-frame removal by embedding cosine similarity. Counterpart of
storygen_tpu/data_process/dedup.py: for each consecutive pair of frames
whose embeddings have cosine >= 0.75, the EARLIER frame is dropped.

The embedder is any callable (B, H, W, 3) float [0, 1] -> (B, D):
`dino_embedder` runs DINO ViT-B/8 from torch.hub's local cache on the
card; `classical_embedder` needs no weights; `default_embedder` takes
DINO when its cache is there, else the classical one.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np

# DINO ViT-B/8: the torch.hub repository and its checkpoint file, as
# torch.hub caches them (the hub's `<owner>_<repo>_<ref>` folder and the
# basename of the weights' URL under checkpoints/)
DINO_REPO = "facebookresearch_dino_main"
DINO_MODEL = "dino_vitb8"
DINO_WEIGHTS = "dino_vitbase8_pretrain.pth"


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a, b) /
                 (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def find_duplicates(embeddings: np.ndarray,
                    threshold: float = 0.75) -> List[int]:
    """Indices to DELETE: for each consecutive pair with cosine >=
    threshold the EARLIER frame is dropped (the later one is kept)."""
    drop = []
    for i in range(len(embeddings) - 1):
        if cosine(embeddings[i], embeddings[i + 1]) >= threshold:
            drop.append(i)
    return drop


def dedup_frames(paths: Sequence[str], embed_fn: Callable,
                 threshold: float = 0.75, batch: int = 16,
                 delete: bool = False) -> List[str]:
    """Return the kept paths (optionally deleting dropped files)."""
    from PIL import Image
    embs = []
    for i in range(0, len(paths), batch):
        imgs = np.stack([
            np.asarray(Image.open(p).convert("RGB").resize((224, 224)),
                       dtype=np.float32) / 255.0
            for p in paths[i:i + batch]])
        embs.append(np.asarray(embed_fn(imgs)))
    embs = np.concatenate(embs) if embs else np.zeros((0, 1))
    dropped = set(find_duplicates(embs, threshold))
    kept = [p for i, p in enumerate(paths) if i not in dropped]
    if delete:
        for i in dropped:
            os.remove(paths[i])
    return kept


def dino_embedder(hub_dir: Optional[str] = None, device=None) -> Callable:
    """DINO ViT-B/8 embeddings on `device` (None: the card). The model
    loads from torch.hub's cache (`hub_dir`, default torch.hub.get_dir())
    and nothing is fetched: FileNotFoundError if the repository or its
    checkpoint is not cached there."""
    import torch
    from storygen_tpu_torch.utils.device import resolve_device
    hub_dir = hub_dir or torch.hub.get_dir()
    repo = os.path.join(hub_dir, DINO_REPO)
    weights = os.path.join(hub_dir, "checkpoints", DINO_WEIGHTS)
    for path in (repo, weights):
        if not os.path.exists(path):
            raise FileNotFoundError(f"DINO is not in torch.hub's cache: no "
                                    f"{path}")
    dev = resolve_device(device)
    prev = torch.hub.get_dir()
    torch.hub.set_dir(hub_dir)  # the repository reads its weights there
    try:
        net = torch.hub.load(repo, DINO_MODEL, source="local")
    finally:
        torch.hub.set_dir(prev)
    net = net.to(dev).eval()
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    def fn(batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy((batch - mean) / std).permute(0, 3, 1, 2)
        with torch.no_grad():
            return net(x.to(dev)).float().cpu().numpy()

    return fn


def classical_embedder(grid: int = 16) -> Callable:
    """Weights-free embedder: downsampled grayscale intensities (centred
    per image) concatenated with coarse gradient-orientation histograms.
    Near-exact duplicates (consecutive keyframes of a still scene) land at
    cosine ~1 while scene cuts fall well below the 0.75 threshold."""
    def fn(batch: np.ndarray) -> np.ndarray:
        gray = batch.mean(-1)  # (B, H, W) in [0,1]
        b, h, w = gray.shape
        # crop to a multiple of `grid` so any input size works (the
        # dedup_frames path resizes to 224, already divisible)
        if h % grid or w % grid:
            if h < grid or w < grid:
                raise ValueError(
                    f"images must be at least {grid}x{grid}, got {h}x{w}")
            h, w = h - h % grid, w - w % grid
            gray = gray[:, :h, :w]
        small = gray.reshape(b, grid, h // grid, grid,
                             w // grid).mean((2, 4))      # (B, g, g)
        # center per image so cosine measures pattern correlation, not
        # the shared DC brightness
        small = small - small.mean(axis=(1, 2), keepdims=True)
        gy, gx = np.gradient(gray, axis=(1, 2))
        mag = np.sqrt(gx * gx + gy * gy)
        ang = np.arctan2(gy, gx)  # [-pi, pi]
        nbins = 8
        bins = ((ang + np.pi) / (2 * np.pi) * nbins).astype(int) % nbins
        hist = np.zeros((b, nbins), np.float32)
        for k in range(nbins):
            hist[:, k] = (mag * (bins == k)).reshape(b, -1).sum(1)
        hist /= hist.sum(1, keepdims=True) + 1e-8
        feat = np.concatenate([small.reshape(b, -1), hist * grid], axis=1)
        return feat.astype(np.float32)

    return fn


def default_embedder(device=None) -> Callable:
    """DINO on `device` when torch.hub's cache holds it, else the
    classical embedder (host code, no weights)."""
    try:
        return dino_embedder(device=device)
    except FileNotFoundError:
        return classical_embedder()
