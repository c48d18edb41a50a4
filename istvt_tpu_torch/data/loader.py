"""A prefetching clip loader and the host -> card feed (counterpart of
istvt_tpu/data/loader.py).

`ClipLoader` makes each batch's items on `num_workers` threads (PIL and the
native decoder release the GIL; no torch operation runs on them, since
torch's own intra-op threads times the workers would oversubscribe the
CPU) and keeps `prefetch` collated batches ahead of the consumer, in index
order. `device_feed` moves each batch to the card through pinned host
memory (pinned on a background thread) on a copy stream, one batch ahead
of the consumer: the pinning and the copy of batch N+1 overlap the step on
batch N (the counterpart of JAX's asynchronous device_put). `device_normalize` is the on-card
(x/255 - mean)/std of uint8 (raw_uint8) clips.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List

import numpy as np
import torch


def collate(items: List[Dict]) -> Dict:
    """Stack a list of item dicts into one batch dict; values that are not
    arrays or numbers (the 'paths' lists) stay lists."""
    out: Dict = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or \
                isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class _Failed:
    """A producer's exception, handed to the consumer to raise."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ClipLoader:
    """Iterable over shuffled, collated numpy batches; the order of each
    epoch is np.random.RandomState((seed, epoch)).shuffle of the indices,
    as in the JAX ClipLoader, and batches come out in that order."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = True,
                 drop_last: bool = False, num_workers: int = 8,
                 prefetch: int = 2, seed: int = 0,
                 host_count: int = 1, host_index: int = 0):
        if host_count > 1:
            raise NotImplementedError(
                "a host-sliced loader (host_count > 1) is not ported yet "
                "(ROADMAP.md queue 1, 'Parallelism')")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
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

    def __iter__(self) -> Iterator[Dict]:
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator[Dict]:
        """The epoch's batches from the start-th on; the earlier ones are
        neither made nor decoded (a resumed run picks up its epoch where it
        stopped). They are made `prefetch` batches ahead (_background)."""
        batches = self.index_batches()[start:]

        def made():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idxs in batches:
                    yield collate(list(pool.map(self.dataset.__getitem__,
                                                [int(i) for i in idxs])))

        return _background(made, self.prefetch, "ClipLoader-producer")


def _background(make: Callable[[], Iterator], ahead: int,
                name: str) -> Iterator:
    """The items of make() in their order, made on a daemon thread `name` that
    keeps up to `ahead` of them queued. When the consumer leaves (break, an
    exception, close) the thread is told to stop, closes make()'s iterator
    and the queue is drained, so it neither keeps the process alive nor
    blocks on a full queue; an exception on the thread is raised to the
    consumer."""
    stop = threading.Event()
    q: "queue.Queue" = queue.Queue(maxsize=ahead)

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        it = make()
        try:
            for x in it:
                if not put(x):
                    return
        except BaseException as e:  # handed to the consumer
            put(_Failed(e))
            return
        finally:
            it.close()
        put(None)

    threading.Thread(target=produce, daemon=True, name=name).start()
    try:
        while True:
            x = q.get()
            if x is None:
                break
            if isinstance(x, _Failed):
                raise x.exc
            yield x
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def device_normalize(x: torch.Tensor, mean: float = 0.5, std: float = 0.5,
                     dtype=None) -> torch.Tensor:
    """(x/255 - mean)/std of uint8 clips on their device: cast to `dtype`
    (f32 by default) first, then each operation in that dtype, in JAX's
    order (loader.py:131-142), so a bf16 ingest rounds as JAX's does."""
    dtype = dtype or torch.float32
    x = x.to(dtype)
    t = lambda v: torch.tensor(v, dtype=dtype, device=x.device)  # noqa: E731
    return (x / t(255.0) - t(mean)) / t(std)


def _as_tensors(batch: Dict) -> Dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def device_feed(loader: Iterable[Dict], device) -> Iterator[Dict]:
    """The batches of `loader` (numpy dicts) as tensors on `device`; values
    that are not arrays (the 'paths' lists) pass as they are.

    A background thread (_background) makes each batch's arrays tensors
    one batch ahead of the consumer, in pinned host memory on CUDA, so the
    pinning copy overlaps the consumer's step. On CUDA the consumer's thread
    then copies them to the card with non_blocking copies on a side stream,
    one batch ahead: the consumer's stream waits on the copy's event before
    it gets the batch, each tensor is marked used on that stream
    (record_stream, so the caching allocator does not hand its memory out
    while the consumer's work is queued), and each pinned source is held
    until its copy's event has completed. On the CPU the tensors are the
    batch (no pinning, which needs CUDA)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    index = (device.index if device.index is not None
             else torch.cuda.current_device()) if cuda else None

    def staged():
        it = iter(loader)
        try:
            if cuda:
                torch.cuda.set_device(index)
            for batch in it:
                out = _as_tensors(batch)
                if cuda:
                    out = {k: v.pin_memory() if isinstance(v, torch.Tensor)
                           else v for k, v in out.items()}
                yield out
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    host = _background(staged, 1, "device_feed-stage")
    inflight = []   # (event, pinned sources) of copies not seen finished
    try:
        if not cuda:
            yield from host
            return
        copy_stream = torch.cuda.Stream(device)

        def issue(batch):
            pinned, out = [], {}
            with torch.cuda.stream(copy_stream):
                for k, v in batch.items():
                    if isinstance(v, torch.Tensor):
                        pinned.append(v)
                        out[k] = v.to(device, non_blocking=True)
                    else:
                        out[k] = v
                done = torch.cuda.Event()
                done.record(copy_stream)
            inflight[:] = [(e, p) for e, p in inflight if not e.query()]
            inflight.append((done, pinned))
            return out, done

        nxt = next(host, None)
        pending = issue(nxt) if nxt is not None else None
        while pending is not None:
            out, done = pending
            nxt = next(host, None)
            pending = issue(nxt) if nxt is not None else None
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
            yield out
    finally:
        for done, _ in inflight:
            done.synchronize()
        host.close()
