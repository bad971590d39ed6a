"""FID: the Frechet distance between two image sets' feature statistics.

Counterpart of storygen_tpu/evaluation/fid.py in numpy (float64): the
matrix square root by eigendecomposition of the symmetrised product, the
statistics and `compute_fid` over two image folders. The feature extractor
is the caller's `feature_fn` (a batch (B, H, W, 3) in [0, 1] -> (B, D)
features, e.g. the CLIP image tower for a "CLIP-FID"): the port builds no
Inception-v3 extractor yet (no Inception state dict ships with the
repository), and nothing is fetched.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}), with (S1 S2)^{1/2}
    taken as sqrt(sqrt(S1) S2 sqrt(S1)), which keeps it PSD."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def feature_statistics(features: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of (N, D) features; N < 2 has no covariance
    and raises (numpy would take one row as D observations of one
    variable)."""
    if len(features) < 2:
        raise ValueError(f"{len(features)} feature rows: the covariance "
                         "needs at least 2")
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    return frechet_distance(*feature_statistics(feats_a),
                            *feature_statistics(feats_b))


def _iter_image_batches(paths: Sequence[str], batch: int, size: int):
    """(B, size, size, 3) float32 batches in [0, 1], each image RGB and
    resized by PIL's default filter."""
    from PIL import Image
    for i in range(0, len(paths), batch):
        imgs = [np.asarray(Image.open(p).convert("RGB")
                           .resize((size, size)), dtype=np.float32) / 255.0
                for p in paths[i:i + batch]]
        yield np.stack(imgs)


def compute_fid(dir_gt: str, dir_gen: str,
                feature_fn: Optional[Callable] = None,
                batch_size: int = 32, size: int = 299) -> float:
    """FID between two image folders' `feature_fn` features."""
    if feature_fn is None:
        raise ValueError("compute_fid needs a feature_fn: the port builds no "
                         "Inception-v3 extractor yet (no Inception state "
                         "dict in the repository) and fetches nothing")

    def dir_features(d):
        paths = sorted(os.path.join(d, f) for f in os.listdir(d)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        feats = [feature_fn(b)
                 for b in _iter_image_batches(paths, batch_size, size)]
        return np.concatenate(feats)

    return fid_from_features(dir_features(dir_gt), dir_features(dir_gen))
