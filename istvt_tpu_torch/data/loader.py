"""A synchronous clip loader (counterpart of istvt_tpu/data/loader.py).

Batches, a per-epoch shuffle from (seed, epoch) with the JAX loader's
order, and drop_last. Decoding workers, prefetch and multi-host slicing
are ROADMAP.md queue 1 work ('Training'): items are made in the calling
thread, one batch at a time.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def collate(items: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack a list of item dicts into one batch dict."""
    return {k: np.stack([np.asarray(it[k]) for it in items])
            for k in items[0]}


class ClipLoader:
    """Iterable over shuffled, collated numpy batches; the order of each
    epoch is np.random.RandomState((seed, epoch)).shuffle of the indices,
    as in the JAX ClipLoader."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState((self.seed, self.epoch)).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches from the start-th on (the earlier ones are
        not made): a resumed run picks up its epoch where it stopped."""
        for idxs in self.index_batches()[start:]:
            yield collate([self.dataset[int(i)] for i in idxs])
