"""Read-only HDF5 video store in the reference layout (port of
extdm_tpu/data/h5.py's ``HDF5VideoStore`` read API).

A store is a directory of shards (or one ``.hdf5``/``.h5`` file); each shard
holds ``len/<i>`` (frame counts) and ``<i>/<frame>`` (one dataset per
frame). ``h5py`` is imported when a store opens: without it the store
raises; use ``InMemoryVideoStore`` (``data/synthetic.py``) instead.
"""
from __future__ import annotations

import glob
import os
import threading

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("HDF5VideoStore needs h5py, which is not installed; serve videos "
                          "from an InMemoryVideoStore instead") from e
    return h5py


class HDF5VideoStore:
    """Videos of a directory of shards: ``video_length``, ``read_frames``,
    ``attr``. Shard handles are opened once per thread."""

    def __init__(self, data_path: str):
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

    def read_frames(self, idx: int, start: int, num: int) -> np.ndarray:
        """Frames [start, start + num) of video `idx` (cut at its end), stacked."""
        shard_idx, key = self.get_indices(idx % self.total_num)
        stop = min(start + num, self._shard_video_len(shard_idx, key))
        grp = self._open(shard_idx)[key]
        return np.stack([grp[str(i)][()] for i in range(start, stop)])

    def attr(self, name: str):
        """A top-level scalar dataset of shard 0 (UCF's num_train/num_test), or None."""
        f = self._open(0)
        return f[name][()] if name in f else None

    def close(self) -> None:
        for f in getattr(self._local, "handles", {}).values():
            f.close()
        self._local.handles = {}
