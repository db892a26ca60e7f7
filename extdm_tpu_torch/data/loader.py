"""Batches with a two-stage prefetch onto the card (port of
extdm_tpu/data/loader.py).

A load stage makes each batch in numpy; a transfer thread turns the arrays
into tensors on ``device``: on a CUDA device through pinned host memory and a
``non_blocking`` copy on a stream of its own, which the consumer's stream
waits for. Batch order, ``drop_last`` and the shuffle seed are the JAX
loader's. Ship the stored uint8 layout (``VideoDataset(..., raw_uint8=True)``)
and canonicalise on the card with ``canonicalize_clips``: a quarter of the
float32 bytes cross to the card.

Two kinds of workers make the batches:

- ``worker_type="thread"``: a thread pool maps ``dataset[i]`` over a batch's
  indices, and ``collate_fn`` stacks the items.
- ``worker_type="process"``: a pool of ``num_workers`` processes forked when
  the loader is made builds whole batches, so the GIL-bound item work (the
  host augmentation) runs on several cores. Before each batch a worker
  reseeds ``random``, ``np.random`` and every ``rng`` RandomState along the
  ``.dataset`` chain from ``seed * 1_000_003 + batch counter``, so a batch is
  the same whichever worker makes it. Batches come back in order, at most
  ``num_workers + prefetch`` in flight; a worker's exception re-raises on
  the consumer, and a worker that dies raises ``BrokenProcessPool`` there
  (a ``multiprocessing.Pool`` would wait for its batch forever). Workers
  return numpy only and run torch on one thread (a thread pool inherited
  through fork can hang); the transfer to the card stays in this process.
  Where fork is missing this raises. Data made before the loader (a
  prefilled clip cache) is shared with the workers. ``close()`` stops them
  (after the batches they are making).

``batch_items=True`` builds each batch with the dataset's ``get_batch``
(every item read, then the augmentation over the whole batch) in place of
items and ``collate_fn``.

Data parallel, ``group`` (a ``parallel.DataGroup``) makes the loader ship
only this rank's rows of each global batch of ``batch_size``: the same
permutation and batches as one process, rows [r B / n, (r + 1) B / n) of
each. Thread workers load only those rows. A process worker builds the
whole global batch and keeps the rank's rows, since its reseeded draws
follow the items in order: each rank does one process's host work.
"""
from __future__ import annotations

import collections
import multiprocessing
import queue
import random
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch


def default_collate(items: Sequence[Any]):
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        return tuple(default_collate(list(col)) for col in zip(*items))
    if isinstance(first, np.ndarray):
        return np.stack(items)
    return np.asarray(items)


def canonicalize_clips(clips: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) clips in a stored layout -> (B, T, H, W, 3) float32 in
    [0, 1] on the clips' device: integers are divided by 255; gray (B, T, H,
    W), channels-first (B, T, 1|3, H, W) and channels-last (B, T, H, W, 1|3)
    are taken, as ``to_rgb_video`` takes one clip."""
    x = clips.float() / 255.0 if not torch.is_floating_point(clips) else clips.float()
    if x.ndim == 4:
        x = x[..., None]
    elif x.shape[2] in (1, 3) and x.shape[-1] not in (1, 3):
        x = x.permute(0, 1, 3, 4, 2)
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    return x.contiguous()


def _map_arrays(fn, obj):
    if isinstance(obj, np.ndarray):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_arrays(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_map_arrays(fn, v) for v in obj)
    return obj


def _tensors(obj):
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, (dict, tuple)):
        return [t for v in (obj.values() if isinstance(obj, dict) else obj) for t in _tensors(v)]
    return []


def _load_items(dataset, collate_fn: Callable, batch_items: bool, indices, rows: slice,
                map_fn=map):
    """Rows `rows` of the batch of `indices`: ``dataset.get_batch`` with
    `batch_items`, else the items (``map_fn`` over ``dataset[i]``) stacked by
    `collate_fn`."""
    ids = [int(i) for i in indices]
    if batch_items:
        return _map_arrays(lambda a: a[rows], dataset.get_batch(ids))
    return collate_fn(list(map_fn(dataset.__getitem__, ids))[rows])


def _reseed_chain(ds, seed: int) -> None:
    """Reseed ``random``, ``np.random`` and the ``rng`` RandomState of every
    dataset along a wrapper chain (e.g. DatasetRepeater -> TwoFramesDataset)."""
    random.seed(seed)
    np.random.seed(seed % 2**32)
    seen = set()
    while ds is not None and id(ds) not in seen:
        seen.add(id(ds))
        if isinstance(getattr(ds, "rng", None), np.random.RandomState):
            ds.rng = np.random.RandomState(seed % 2**32)
        ds = getattr(ds, "dataset", None)


# A worker process's dataset, collate_fn and batch_items, set by its initializer.
_WORKER: Optional[tuple] = None


def _worker_init(dataset, collate_fn: Callable, batch_items: bool) -> None:
    global _WORKER
    torch.set_num_threads(1)
    _WORKER = (dataset, collate_fn, batch_items)


def _worker_batch(task):
    indices, seed, rows = task
    dataset, collate_fn, batch_items = _WORKER
    _reseed_chain(dataset, seed)
    return _load_items(dataset, collate_fn, batch_items, indices, rows)


class DataLoader:
    """``DataLoader(dataset, batch_size, shuffle, num_workers, drop_last,
    seed, collate_fn, prefetch, device, worker_type, group, batch_items)``.
    With ``device=None`` batches stay numpy; otherwise every array becomes a
    tensor on `device` (a CUDA device needs a card). With a data group, each
    batch is this rank's rows of the global batch. ``wait_s`` adds up the
    seconds the consumer spent waiting for a batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 8,
                 drop_last: bool = True, seed: int = 0, collate_fn: Callable = default_collate,
                 prefetch: int = 2, device=None, worker_type: str = "thread", group=None,
                 batch_items: bool = False):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type={worker_type!r}: 'thread' or 'process'")
        if batch_items and not hasattr(dataset, "get_batch"):
            raise ValueError(f"batch_items: {type(dataset).__name__} has no get_batch")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.seed = seed
        self.batch_items = batch_items
        self.rng = np.random.RandomState(seed)
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' or None")
        self.group = group
        self.pool = self.proc_pool = None
        self._task_counter = 0
        self._in_flight = num_workers + prefetch
        if num_workers and worker_type == "process":
            try:
                ctx = multiprocessing.get_context("fork")
            except ValueError as e:
                raise RuntimeError("worker_type='process' forks its workers; this platform "
                                   "has no fork: use worker_type='thread'") from e
            self.proc_pool = ProcessPoolExecutor(num_workers, mp_context=ctx,
                                                 initializer=_worker_init,
                                                 initargs=(dataset, collate_fn, batch_items))
            self.proc_pool.submit(int).result()  # fork every worker now, from this thread
        elif num_workers:
            self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.wait_s = 0.0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def close(self) -> None:
        """Stop the worker processes (or threads)."""
        if self.proc_pool is not None:
            self.proc_pool.shutdown(wait=True, cancel_futures=True)
            self.proc_pool = None
        if self.pool is not None:
            self.pool.shutdown(wait=False)
            self.pool = None

    def _batches(self) -> Iterator[np.ndarray]:
        """The global batches' indices in order."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for s in range(0, stop, self.batch_size):
            yield idx[s:s + self.batch_size]

    def _rows(self, n: int) -> slice:
        return slice(None) if self.group is None else self.group.rows(n)

    def _host_batches(self) -> Iterator[Any]:
        """The numpy batches in order, from the thread or the process workers."""
        if self.proc_pool is None:
            map_fn = self.pool.map if self.pool is not None else map
            for indices in self._batches():  # only this rank's rows
                yield _load_items(self.dataset, self.collate_fn, self.batch_items,
                                  indices[self._rows(len(indices))], slice(None), map_fn)
            return
        pending = collections.deque()
        for indices in self._batches():
            self._task_counter += 1
            task = ([int(i) for i in indices], self.seed * 1_000_003 + self._task_counter,
                    self._rows(len(indices)))
            pending.append(self.proc_pool.submit(_worker_batch, task))
            if len(pending) >= self._in_flight:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()

    def _transfer(self, batch, stream):
        """Arrays -> tensors on the device; on CUDA also the event that marks
        the copies' end on `stream`."""
        if self.device is None:
            return batch, None
        if self.device.type != "cuda":
            return _map_arrays(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device), batch), None
        with torch.cuda.stream(stream):
            out = _map_arrays(lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                              .to(self.device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def __iter__(self) -> Iterator[Any]:
        batch_iter = self._host_batches()
        sentinel = object()
        q_host: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        q_dev: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stream = torch.cuda.Stream(self.device) if self.device is not None \
            and self.device.type == "cuda" else None

        def load_stage():
            try:
                for batch in batch_iter:
                    q_host.put(batch)
                q_host.put(sentinel)
            except BaseException as e:  # re-raised on the consumer's side
                q_host.put(e)

        def transfer_stage():
            while True:
                item = q_host.get()
                if item is sentinel or isinstance(item, BaseException):
                    q_dev.put(item)
                    return
                try:
                    q_dev.put(self._transfer(item, stream))
                except BaseException as e:
                    q_dev.put(e)
                    return

        threading.Thread(target=load_stage, daemon=True).start()
        threading.Thread(target=transfer_stage, daemon=True).start()
        while True:
            t0 = time.perf_counter()
            item = q_dev.get()
            self.wait_s += time.perf_counter() - t0
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            batch, done = item
            if done is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                for t in _tensors(batch):
                    t.record_stream(current)
            yield batch
