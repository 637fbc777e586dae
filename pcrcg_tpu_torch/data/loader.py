"""Threaded prefetching loader: host IO and augmentation overlapped with
device compute (counterpart of ``pcrcg_tpu/data/loader.py``).

Replaces the reference's multi-worker torch DataLoader + CPU C++ collation
(datasets/dataloader.py:459-472, num_workers=10).  The pyramid builds on
the device, so host work is file IO + augmentation + padding, plus PNG
decodes and SuperGlue npz parsing on the image path: ``num_threads``
workers build batches concurrently (ordered output, bounded prefetch).
Randomness comes from per-batch spawned generators, so the epoch's data is
the same for a given seed whatever ``num_threads``.

Workers touch no CUDA tensor: a batch is a ``PairBatch`` of CPU tensors
and an image dict of CPU tensors (page-locked with ``pin_memory``), which
the caller moves to the device (``to_device``).
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from pcrcg_tpu_torch.data.pair import PairBatch, make_pair_batch


class PairLoader:
    """Iterates (PairBatch, images or None) over a dataset of sample dicts.

    The epoch order is shuffled when shuffle=True; incomplete trailing
    batches are dropped (static shapes).  Evaluation protocols score every
    pair (reference lib/benchmark.py:271-337 walks the full split):
    construct eval loaders with ``drop_last=False``, which refuses ragged
    splits instead of dropping the tail."""

    def __init__(
        self,
        dataset,
        budget: int,
        batch_size: int = 1,
        shuffle: bool = False,
        num_threads: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        image_keys: Sequence[str] = ("colors", "depths", "world2cam", "valid_maps", "intrinsics"),
        drop_last: bool = True,
        pin_memory: bool = False,
    ):
        if not drop_last and len(dataset) % batch_size != 0:
            raise ValueError(
                f"drop_last=False but len(dataset)={len(dataset)} is not a "
                f"multiple of batch_size={batch_size}: the trailing "
                f"{len(dataset) % batch_size} pair(s) would be silently "
                "dropped.  Use batch_size=1 (or a divisor of the split) "
                "for evaluation."
            )
        self.dataset = dataset
        self.budget = budget
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.seed = seed
        self.rng = np.random.default_rng(seed)  # epoch shuffles only (main thread)
        self.image_keys = image_keys
        self.pin_memory = pin_memory
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Continue as this loader would after ``epoch`` passes (a resumed
        run): the shuffle generator replays that many shuffles and the
        per-batch generators follow from ``epoch``."""
        self.rng = np.random.default_rng(self.seed)
        if self.shuffle:
            for _ in range(epoch):
                self.rng.shuffle(np.arange(len(self.dataset)))
        self._epoch = epoch

    def _get_sample(self, index: int, rng: np.random.Generator):
        # Datasets whose samples draw randomness expose ``get(item, rng)`` so
        # concurrent workers never share a generator.
        get = getattr(self.dataset, "get", None)
        if get is not None:
            return get(index, rng)
        return self.dataset[index]

    def _make_batch(self, indices, rng: np.random.Generator) -> tuple[PairBatch, Optional[dict]]:
        samples = [self._get_sample(int(i), rng) for i in indices]
        batch = make_pair_batch(samples, self.budget, rng=rng)
        images = None
        if all(k in samples[0] for k in self.image_keys):
            images = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                      for k in self.image_keys}
        if self.pin_memory:
            batch = PairBatch(*(t.pin_memory() for t in (batch.points, batch.masks,
                                                         batch.features, batch.rot,
                                                         batch.trans)))
            if images is not None:
                images = {k: v.pin_memory() for k, v in images.items()}
        return batch, images

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(n_batches)
        ]
        # One generator per batch: deterministic in (seed, epoch, batch
        # index) and safe to use from any worker thread.
        ss = np.random.SeedSequence(entropy=(self.seed, self._epoch))
        rngs = [np.random.default_rng(child) for child in ss.spawn(n_batches)]
        self._epoch += 1
        if self.num_threads <= 1 or n_batches <= 1:
            for b, r in zip(batches, rngs):
                yield self._make_batch(b, r)
            return

        # Ordered concurrent prefetch: up to num_threads batches build at
        # once, at most num_threads + prefetch outstanding.
        executor = ThreadPoolExecutor(max_workers=self.num_threads,
                                      thread_name_prefix="pairloader")
        try:
            window = self.num_threads + self.prefetch
            futures: deque = deque()
            next_submit = 0
            while next_submit < n_batches and len(futures) < window:
                futures.append(executor.submit(self._make_batch, batches[next_submit],
                                               rngs[next_submit]))
                next_submit += 1
            while futures:
                item = futures.popleft().result()  # re-raises worker errors
                if next_submit < n_batches:
                    futures.append(executor.submit(self._make_batch, batches[next_submit],
                                                   rngs[next_submit]))
                    next_submit += 1
                yield item
        finally:
            executor.shutdown(wait=False, cancel_futures=True)


def to_device(batch: PairBatch, images: Optional[dict], device) -> tuple[PairBatch, Optional[dict]]:
    """A loader item on ``device`` (asynchronous copies from pinned memory)."""
    batch = PairBatch(*(t.to(device, non_blocking=True) for t in (
        batch.points, batch.masks, batch.features, batch.rot, batch.trans)))
    if images is not None:
        images = {k: v.to(device, non_blocking=True) for k, v in images.items()}
    return batch, images
