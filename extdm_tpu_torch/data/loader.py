"""Batches with a two-stage prefetch onto the card (port of
extdm_tpu/data/loader.py, thread workers).

A load thread maps ``dataset[i]`` over each batch's indices on a thread pool
and collates in numpy (``default_collate``); a transfer thread turns the
arrays into tensors on ``device``: on a CUDA device through pinned host
memory and a ``non_blocking`` copy on a stream of its own, which the
consumer's stream waits for. Batch order, ``drop_last`` and the shuffle seed
are the JAX loader's. Ship the stored uint8 layout (``VideoDataset(...,
raw_uint8=True)``) and canonicalise on the card with ``canonicalize_clips``:
a quarter of the float32 bytes cross to the card.

Data parallel, ``group`` (a ``parallel.DataGroup``) makes the loader load
and ship only this rank's rows of each global batch of ``batch_size``: the
same permutation and batches as one process, rows [r B / n, (r + 1) B / n)
of each.

Process workers (``worker_type="process"``) are not ported yet.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Sequence

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


class DataLoader:
    """``DataLoader(dataset, batch_size, shuffle, num_workers, drop_last,
    seed, collate_fn, prefetch, device, worker_type, group)``. With
    ``device=None`` batches stay numpy; otherwise every array becomes a
    tensor on `device` (a CUDA device needs a card). With a data group, each
    batch is this rank's rows of the global batch. ``wait_s`` adds up the
    seconds the consumer spent waiting for a batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 8,
                 drop_last: bool = True, seed: int = 0, collate_fn: Callable = default_collate,
                 prefetch: int = 2, device=None, worker_type: str = "thread", group=None):
        if worker_type != "thread":
            raise NotImplementedError(f"worker_type={worker_type!r}: only thread workers are "
                                      "ported")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' or None")
        self.group = group
        self.pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers else None
        self.wait_s = 0.0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for s in range(0, stop, self.batch_size):
            batch = idx[s:s + self.batch_size]
            yield batch if self.group is None else batch[self.group.rows(len(batch))]

    def _load(self, indices) -> Any:
        ids = [int(i) for i in indices]
        items = (list(self.pool.map(self.dataset.__getitem__, ids)) if self.pool is not None
                 else [self.dataset[i] for i in ids])
        return self.collate_fn(items)

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
        batch_iter = self._batches()
        sentinel = object()
        q_host: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        q_dev: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stream = torch.cuda.Stream(self.device) if self.device is not None \
            and self.device.type == "cuda" else None

        def load_stage():
            try:
                for indices in batch_iter:
                    q_host.put(self._load(indices))
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
