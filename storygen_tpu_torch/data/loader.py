"""Batching for training: `collate`, the shuffling, prefetching
`DataLoader` and a seeded synthetic dataset.

Counterpart of storygen_tpu/data/loader.py (`collate` and `DataLoader`,
with the same seeded order of samples). Samples carry token ids, or
prompts that a tokenizer (data/tokenizer.py) turns into ids as the batch
is made.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


def collate(samples: Sequence[Dict],
            tokenizer: Optional[Callable] = None) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into batch arrays. Per-frame arrays stack
    batch-major; ref_images to (N_refs, B, H, W, 3), ref_latent_moments to
    (N_refs, B, h, w, 8) and ref_input_ids to (N_refs, B, 77), the
    ref-major layout the training step takes. With a tokenizer, `prompt`
    becomes input_ids (B, 77) and `ref_prompts` ref_input_ids (N_refs, B,
    77); without one they pass through as lists (the validation renders
    read them). Ids are int64."""
    out: Dict[str, np.ndarray] = {}
    keys = samples[0].keys()
    for key in ("image", "mask", "latent_moments"):
        if key in keys:
            out[key] = np.stack([s[key] for s in samples])
    if "input_ids" in keys:
        out["input_ids"] = np.stack(
            [s["input_ids"] for s in samples]).astype(np.int64)
    for key in ("ref_images", "ref_latent_moments"):
        if key in keys:
            out[key] = np.stack([s[key] for s in samples], axis=1)
    if "ref_input_ids" in keys:
        out["ref_input_ids"] = np.stack(
            [s["ref_input_ids"] for s in samples], axis=1).astype(np.int64)
    if "prompt" in keys:
        prompts = [s["prompt"] for s in samples]
        if tokenizer is None:
            out["prompt"] = prompts
        else:
            out["input_ids"] = np.asarray(tokenizer(prompts), np.int64)
    if "ref_prompts" in keys:
        refs = [s["ref_prompts"] for s in samples]
        if tokenizer is None:
            out["ref_prompts"] = refs
        else:
            out["ref_input_ids"] = np.stack(
                [np.asarray(tokenizer([r[i] for r in refs]), np.int64)
                 for i in range(len(refs[0]))])
    return out


class DataLoader:
    """Collated batches forever, epoch after epoch.

    Each epoch is a permutation from one seeded numpy RandomState (every
    shard draws the same one and takes every num_shards-th index from
    shard_id on, so the shards' batches never overlap); a dataset with a
    `_rng.set_epoch` hears the epoch first. drop_last drops an epoch's
    partial batch. Samples load on a pool of `num_threads` threads and
    batches are made `prefetch` ahead on a thread of their own (prefetch 0:
    in the caller's thread). `start` skips that many batches first without
    loading them, so a resumed run continues where its checkpoint left off.
    `tokenizer` goes to `collate`. An error in a sample's loading is raised
    to the caller."""

    def __init__(self, dataset, batch_size: int,
                 tokenizer: Optional[Callable] = None, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 2,
                 num_threads: int = 4, num_shards: int = 1, shard_id: int = 0,
                 start: int = 0):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        per_epoch = len(range(shard_id, len(dataset), num_shards))
        full = per_epoch // batch_size if batch_size > 0 else 0
        if full == 0 and (drop_last or per_epoch == 0):
            raise ValueError(f"{per_epoch} samples per epoch make no batch "
                             f"of {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.start = start
        self._rng = np.random.RandomState(seed)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        self._rng.shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_id::self.num_shards]
        return idx

    def _batch_indices(self) -> Iterator[np.ndarray]:
        """The sample indices of each batch, epoch after epoch, after the
        first `start` batches."""
        epoch, skip = 0, self.start
        while True:
            rng = getattr(self.dataset, "_rng", None)
            if hasattr(rng, "set_epoch"):
                rng.set_epoch(epoch)
            epoch += 1
            idx = self._epoch_indices()
            full = len(idx) // self.batch_size * self.batch_size
            for s in range(0, full if self.drop_last else len(idx),
                           self.batch_size):
                if skip:
                    skip -= 1
                    continue
                yield idx[s:s + self.batch_size]

    def _batches(self, pool) -> Iterator[Dict[str, np.ndarray]]:
        for chunk in self._batch_indices():
            items = [int(i) for i in chunk]
            samples = (list(pool.map(self.dataset.__getitem__, items))
                       if pool is not None
                       else [self.dataset[i] for i in items])
            yield collate(samples, self.tokenizer)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = (ThreadPoolExecutor(max_workers=self.num_threads)
                if self.num_threads > 1 else None)
        try:
            if self.prefetch <= 0:
                yield from self._batches(pool)
            else:
                yield from self._prefetched(pool)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    def _prefetched(self, pool) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        errors = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches(pool):
                    if not put(batch):
                        return
            except BaseException as e:  # raised again in the caller
                errors.append(e)
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if errors:
                        raise errors[0]
                    return
                yield batch
        finally:
            stop.set()
            t.join()


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
