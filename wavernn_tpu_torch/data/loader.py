"""Data-loading runtime (a copy of ``wavernn_tpu/data/loader.py``).

A minimal Dataset/Sampler/DataLoader stack with thread-pool prefetching:
worker threads overlap ``np.load`` file I/O and collation with the card's
compute, in place of the reference's 2-worker loader processes (ref:
utils/dataset.py:51-56).  Batches are plain numpy, in the same order as the
JAX package's; the train step moves them to the device.
"""

from __future__ import annotations

import concurrent.futures
import random
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence


class Dataset:
    """Map-style dataset interface."""

    def __getitem__(self, index: int) -> Any:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class Sampler:
    """Yields dataset indices; len() is the epoch size."""

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class DataLoader:
    """Batched iterator with threaded prefetch.

    Args:
      dataset: map-style dataset.
      batch_size: items per batch.
      collate_fn: list-of-items → batch (default: list passthrough).
      shuffle: shuffle indices each epoch (ignored when sampler given).
      sampler: optional index sampler (e.g. BinnedLengthSampler).
      num_workers: prefetch threads (0 = synchronous).
      drop_last: drop the trailing partial batch.
      seed: RNG seed for shuffling; epoch number is mixed in for variety.
      prefetch_batches: max in-flight prepared batches.
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        collate_fn: Optional[Callable[[List[Any]], Any]] = None,
        shuffle: bool = False,
        sampler: Optional[Sampler] = None,
        num_workers: int = 2,
        drop_last: bool = False,
        seed: int = 1234,
        prefetch_batches: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or (lambda items: items)
        self.shuffle = shuffle
        self.sampler = sampler
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = max(1, prefetch_batches)
        self._epoch = 0

    def _epoch_indices(self) -> List[int]:
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        return idx

    def _batches(self, indices: Sequence[int]) -> List[List[int]]:
        out = [
            list(indices[i: i + self.batch_size])
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last and out and len(out[-1]) < self.batch_size:
            out.pop()
        return out

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        batches = self._batches(self._epoch_indices())
        self._epoch += 1

        def load(batch_idx: List[int]):
            return self.collate_fn([self.dataset[i] for i in batch_idx])

        if self.num_workers == 0:
            for b in batches:
                yield load(b)
            return

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            window: List[concurrent.futures.Future] = []
            it = iter(batches)
            try:
                for _ in range(self.prefetch_batches):
                    window.append(pool.submit(load, next(it)))
            except StopIteration:
                pass
            while window:
                fut = window.pop(0)
                try:
                    window.append(pool.submit(load, next(it)))
                except StopIteration:
                    pass
                yield fut.result()
