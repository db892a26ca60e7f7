"""HDF5 video store and shard writer in the reference layout (port of
extdm_tpu/data/h5.py's ``HDF5VideoStore`` and ``HDF5VideoWriter``).

A store is a directory of shards (or one ``.hdf5``/``.h5`` file); each shard
holds ``len/<i>`` (frame counts) and ``<i>/<frame>`` (one lzf-compressed
dataset per frame), so the JAX package's shards and the published
preprocessed datasets read as they are. ``h5py`` is imported when a store or
writer opens: without it they raise; use ``InMemoryVideoStore``
(``data/synthetic.py``) instead.
"""
from __future__ import annotations

import glob
import os
import threading
from typing import Optional, Sequence

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the HDF5 video store and writer need h5py, which is not installed; "
                          "serve videos from an InMemoryVideoStore instead") from e
    return h5py


class HDF5VideoStore:
    """Videos of a directory of shards: ``video_length``, ``read_frames``,
    ``attr``. Shard handles are opened once per thread.

    ``cache_mb`` > 0 keeps whole decoded videos in RAM up to that budget
    (checked before each fill, so the last fill may pass it): a fill is
    single-flight under a lock, so a video is read once however many loader
    threads ask for it, and the cached arrays are frozen (``writeable=False``);
    ``prefill_cache()`` fills it in one sequential pass before step 0, and a
    process loader forked after that shares it."""

    def __init__(self, data_path: str, cache_mb: int = 0):
        self._h5 = _h5py()
        self.data_path = data_path
        if os.path.splitext(data_path)[-1] in (".hdf5", ".h5"):
            self.shard_paths = [data_path]
        else:
            self.shard_paths = sorted(glob.glob(os.path.join(data_path, "*.hdf5"))
                                      + glob.glob(os.path.join(data_path, "*.h5")))
        if not self.shard_paths:
            raise FileNotFoundError(f"no .hdf5/.h5 shards under {data_path}")
        self.shard_lengths = []
        for path in self.shard_paths:
            with self._h5.File(path, "r") as f:
                self.shard_lengths.append(len(f["len"].keys()))
        self.cum_lengths = np.cumsum(self.shard_lengths)
        self.total_num = int(self.cum_lengths[-1])
        self._local = threading.local()
        self._lens = {}  # shard -> {key: frame count}; the counts never change
        self.cache_budget = int(cache_mb) * 1024 * 1024
        self.cache_bytes = 0
        self._cache = {}  # (shard, key) -> the whole video, frozen
        self._cache_lock = threading.Lock()

    @property
    def name(self) -> str:
        return self.data_path

    def _open(self, shard_idx: int):
        handles = getattr(self._local, "handles", None)
        if handles is None:
            handles = self._local.handles = {}
        if shard_idx not in handles:
            handles[shard_idx] = self._h5.File(self.shard_paths[shard_idx], "r")
        return handles[shard_idx]

    def get_indices(self, idx: int):
        shard_idx = int(np.digitize(idx, self.cum_lengths))
        idx_in_shard = idx - (int(self.cum_lengths[shard_idx - 1]) if shard_idx else 0)
        return shard_idx, str(idx_in_shard)

    def __len__(self) -> int:
        return self.total_num

    def _shard_video_len(self, shard_idx: int, key: str) -> int:
        lens = self._lens.get(shard_idx)
        if lens is None:
            grp = self._open(shard_idx)["len"]
            lens = self._lens[shard_idx] = {k: int(grp[k][()]) for k in grp.keys()}
        return lens[key]

    def video_length(self, idx: int) -> int:
        shard_idx, key = self.get_indices(idx % self.total_num)
        return self._shard_video_len(shard_idx, key)

    def _read_range(self, shard_idx: int, key: str, start: int, stop: int) -> np.ndarray:
        grp = self._open(shard_idx)[key]
        return np.stack([grp[str(i)][()] for i in range(start, stop)])

    def read_frames(self, idx: int, start: int, num: int) -> np.ndarray:
        """Frames [start, start + num) of video `idx` (cut at its end),
        stacked; a view of the frozen cached video where it is cached."""
        shard_idx, key = self.get_indices(idx % self.total_num)
        total = self._shard_video_len(shard_idx, key)
        stop = min(start + num, total)
        vid = self._cache.get((shard_idx, key))
        if vid is None and self.cache_bytes < self.cache_budget:
            vid = self._cache_fill(shard_idx, key, total)
        if vid is not None:
            return vid[start:stop]
        return self._read_range(shard_idx, key, start, stop)

    def _cache_fill(self, shard_idx: int, key: str, total: int) -> Optional[np.ndarray]:
        """The cached video (all `total` frames), read and inserted if it is
        not cached yet; None when the budget filled up first. The read runs
        under the lock, so callers racing for one video wait for the one
        read."""
        with self._cache_lock:
            vid = self._cache.get((shard_idx, key))
            if vid is not None:
                return vid
            if self.cache_bytes >= self.cache_budget:
                return None
            vid = self._read_range(shard_idx, key, 0, total)
            vid.flags.writeable = False
            self._cache[(shard_idx, key)] = vid
            self.cache_bytes += vid.nbytes
            return vid

    def prefill_cache(self, max_videos: Optional[int] = None) -> int:
        """Cache videos 0, 1, ... (the first `max_videos`) while the budget
        lasts; returns how many of them it found or put in the cache."""
        if self.cache_budget <= 0:
            return 0
        n = self.total_num if max_videos is None else min(max_videos, self.total_num)
        filled = 0
        for idx in range(n):
            if self.cache_bytes >= self.cache_budget:
                break
            shard_idx, key = self.get_indices(idx)
            total = self._shard_video_len(shard_idx, key)
            if self._cache_fill(shard_idx, key, total) is not None:
                filled += 1
        return filled

    def attr(self, name: str):
        """A top-level scalar dataset of shard 0 (UCF's num_train/num_test), or None."""
        f = self._open(0)
        return f[name][()] if name in f else None

    def close(self) -> None:
        for f in getattr(self._local, "handles", {}).values():
            f.close()
        self._local.handles = {}


class HDF5VideoWriter:
    """Writes videos as shards ``<out_path>/shard_0001.hdf5``, ... of
    ``num_per_shard`` videos each, in the reference layout. A directory that
    already holds shards is refused unless ``force``, which deletes them."""

    def __init__(self, out_path: str, num_per_shard: int = 100000,
                 name_fmt: str = "shard_{:04d}.hdf5", force: bool = False):
        self._h5 = _h5py()
        self.out_dir = out_path
        self.num_per_shard = num_per_shard
        self.name_fmt = name_fmt
        if os.path.isdir(self.out_dir):
            existing = (glob.glob(os.path.join(self.out_dir, "*.hdf5"))
                        + glob.glob(os.path.join(self.out_dir, "*.h5")))
            if existing and not force:
                raise ValueError(f"{self.out_dir} already has shards; pass force=True")
            for p in existing:
                os.remove(p)
        else:
            os.makedirs(self.out_dir, exist_ok=True)
        self.shard_number = 0
        self.writer = None
        self.count = 0
        self._new_shard()

    def _new_shard(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self.shard_number += 1
        path = os.path.join(self.out_dir, self.name_fmt.format(self.shard_number))
        self.writer = self._h5.File(path, "w")
        self.writer.create_group("len")
        self.writer.create_group("videos")
        self.count = 0

    def add_video(self, frames: Sequence[np.ndarray], dtype=None) -> int:
        """frames: (H, W[, C]) arrays. Returns the video's index in its shard."""
        w = self.writer
        w["len"].create_dataset(str(self.count), data=len(frames))
        grp = w.create_group(str(self.count))
        for i, frame in enumerate(frames):
            grp.create_dataset(str(i), data=frame, dtype=dtype, compression="lzf")
        idx = self.count
        self.count += 1
        if self.count == self.num_per_shard:
            self._new_shard()
        return idx

    def set_scalar(self, name: str, value) -> None:
        """A top-level scalar dataset in the first shard (``HDF5VideoStore.attr``
        reads it back; UCF stores num_train / num_test so)."""
        if self.shard_number == 1:
            if name in self.writer:
                del self.writer[name]
            self.writer[name] = value
        else:
            with self._h5.File(os.path.join(self.out_dir, self.name_fmt.format(1)), "a") as f:
                if name in f:
                    del f[name]
                f[name] = value

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.writer = None
