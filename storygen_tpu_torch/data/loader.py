"""Batching for training: `collate`, a seeded batch iterator and a seeded
synthetic dataset.

Counterpart of storygen_tpu/data/loader.py (`collate` and the order of
`DataLoader`'s batches). The threaded prefetching loader and the CLIP
tokenizer are not ported yet: samples arrive with token ids.
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np


def collate(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into batch arrays. ref_images stacks to
    (N_refs, B, H, W, 3) and ref_input_ids to (N_refs, B, 77), the
    ref-major layout the training step takes."""
    out: Dict[str, np.ndarray] = {}
    keys = samples[0].keys()
    for key in ("image", "mask"):
        if key in keys:
            out[key] = np.stack([s[key] for s in samples])
    if "input_ids" in keys:
        out["input_ids"] = np.stack(
            [s["input_ids"] for s in samples]).astype(np.int64)
    if "ref_images" in keys:
        out["ref_images"] = np.stack([s["ref_images"] for s in samples],
                                     axis=1)
    if "ref_input_ids" in keys:
        out["ref_input_ids"] = np.stack(
            [s["ref_input_ids"] for s in samples], axis=1).astype(np.int64)
    return out


def batches(dataset, batch_size: int, seed: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Collated batches forever, epoch after epoch, each epoch in a fresh
    permutation from one seeded numpy generator and without its last
    partial batch (DataLoader's order)."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    if n < batch_size or batch_size < 1:
        raise ValueError(f"{n} samples make no batch of {batch_size}")
    while True:
        idx = np.arange(n)
        rng.shuffle(idx)
        for s in range(0, n // batch_size * batch_size, batch_size):
            yield collate([dataset[int(i)] for i in idx[s:s + batch_size]])


class SyntheticStoryDataset:
    """Seeded synthetic stage-2 samples with the StorySalon layout: a
    frame in [-1, 1], its inpainting mask, its caption's token ids, and
    `num_refs` earlier frames with their captions' ids. Sample i is the
    same for a given seed on every machine."""

    def __init__(self, length: int, size: int = 512, num_refs: int = 3,
                 seed: int = 0, vocab_size: int = 49408,
                 max_length: int = 77):
        self.length, self.size, self.num_refs = length, size, num_refs
        self.seed, self.vocab_size = seed, vocab_size
        self.max_length = max_length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if not 0 <= i < self.length:
            raise IndexError(i)
        rs = np.random.RandomState([self.seed, i])
        n, s, t = self.num_refs, self.size, self.max_length
        return {
            "image": rs.uniform(-1, 1, (s, s, 3)).astype(np.float32),
            "mask": (rs.rand(s, s, 1) > 0.8).astype(np.float32),
            "input_ids": rs.randint(0, self.vocab_size, t),
            "ref_images": rs.uniform(-1, 1, (n, s, s, 3)).astype(np.float32),
            "ref_input_ids": rs.randint(0, self.vocab_size, (n, t)),
        }
