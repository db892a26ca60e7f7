"""Auxiliary dataset interfaces (port of extdm_tpu/data/base.py), beside the
main train and eval paths as in the reference:

- ``ConcatDatasetWithIndex``: concatenated datasets; an item comes with the
  index of the dataset that served it.
- ``VideoPaths``: clips read from video files over a frame range, with an
  optional per-frame transform, in [-1, 1].
- ``HDF5InterfaceDataset``: fixed-length clip windows over an
  ``HDF5VideoStore`` (uniform video remap, random start time, optional
  horizontal flip).

All return numpy, channels-last; ``data/loader.py`` makes batches.
"""
from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from extdm_tpu_torch.data.h5 import HDF5VideoStore


class ConcatDatasetWithIndex:
    """Datasets one after another; ``__getitem__`` returns (item, dataset index)."""

    def __init__(self, datasets: Sequence[Any]):
        if not datasets:
            raise ValueError("ConcatDatasetWithIndex needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative_sizes = list(np.cumsum([len(d) for d in self.datasets]))

    def __len__(self) -> int:
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx: int):
        if idx < 0:
            if -idx > len(self):
                raise ValueError("index out of range")
            idx = len(self) + idx
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else idx - self.cumulative_sizes[dataset_idx - 1]
        return self.datasets[dataset_idx][sample_idx], dataset_idx


def read_video_file(path: str) -> np.ndarray:
    """(T, H, W, C) uint8 frames of a video file (imageio's pyav plugin)."""
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError("read_video_file needs imageio, which is not installed") from e
    return np.asarray(iio.imread(path, plugin="pyav"))


class VideoPaths:
    """Clips of video files given (path, start, end) triples: frames
    [start, end) of each file, ``trans`` applied to each frame, as float32
    ``video / 127.5 - 1``. ``labels`` ride along with each item, with the
    file path and the range."""

    def __init__(self, paths: Sequence[str], start_idxs: Sequence[int],
                 end_idxs: Sequence[int],
                 trans: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 labels: Optional[Dict[str, Sequence[Any]]] = None,
                 reader: Callable[[str], np.ndarray] = read_video_file):
        self._length = len(paths)
        self._trans = trans
        self._reader = reader
        self.labels: Dict[str, Sequence[Any]] = dict(labels or {})
        self.labels["file_path"] = list(paths)
        self.labels["start_idx"] = list(start_idxs)
        self.labels["end_idx"] = list(end_idxs)

    def __len__(self) -> int:
        return self._length

    def preprocess_video(self, video_path: str, start_idx: int, end_idx: int) -> np.ndarray:
        video = self._reader(video_path)[start_idx:end_idx].astype(np.uint8)
        if self._trans is not None:
            video = np.stack([self._trans(frame) for frame in video])
        return (video / 127.5 - 1.0).astype(np.float32)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        item: Dict[str, Any] = {"video": self.preprocess_video(
            self.labels["file_path"][i], int(self.labels["start_idx"][i]),
            int(self.labels["end_idx"][i]))}
        for k, v in self.labels.items():
            item[k] = v[i]
        return item


class HDF5InterfaceDataset:
    """Clip windows of ``frames_per_sample`` frames over an HDF5 store: item
    `index` maps uniformly onto the store's videos (so ``total_videos`` items
    span the whole store), then a random (or given) start time after
    ``start_at``; float32 in [0, 1] (integers over 1.5 divided by 255), a
    channel axis added to gray, the clip flipped horizontally with
    probability 1/2 under ``hflip``."""

    def __init__(self, data_dir: str, frames_per_sample: int, random_time: bool = True,
                 total_videos: int = -1, start_at: int = 0,
                 labels: Optional[Dict[str, Any]] = None, hflip: bool = False,
                 seed: Optional[int] = None):
        self.labels = dict(labels or {})
        self.store = HDF5VideoStore(data_dir)
        self.total_videos = total_videos
        self.start_at = start_at
        self.random_time = random_time
        self.frames_per_sample = frames_per_sample
        self.hflip = hflip
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.total_videos if self.total_videos > 0 else len(self.store)

    def max_index(self) -> int:
        return len(self.store)

    def len_of_vid(self, index: int) -> int:
        return self.store.video_length(index % len(self))

    def __getitem__(self, index: int, time_idx: int = 0) -> Dict[str, Any]:
        denom = max(len(self) - 1, 1)
        video_index = int(round(index / denom * (self.max_index() - 1)))
        video_len = self.store.video_length(video_index) - self.start_at
        if self.random_time and video_len > self.frames_per_sample:
            time_idx = int(self._rng.choice(video_len - self.frames_per_sample))
        time_idx += self.start_at
        num = min(self.frames_per_sample, max(video_len, 1))
        clip = self.store.read_frames(video_index, time_idx, num).astype(np.float32)
        if clip.max() > 1.5:
            clip = clip / 255.0
        if clip.ndim == 3:
            clip = clip[..., None]
        if self.hflip and self._rng.rand() < 0.5:
            clip = clip[:, :, ::-1].copy()
        item: Dict[str, Any] = {"video": clip}
        item.update(self.labels)
        return item
