"""Clip sampler over a video store (port of extdm_tpu/data/video_dataset.py):
index remapping, random start time, /255 normalisation or raw uint8, and
the UCF crop and flip. Returns numpy; ``data/loader.py`` makes batches.
"""
from __future__ import annotations

import os
from typing import Tuple, Union

import numpy as np

from extdm_tpu_torch.data.h5 import HDF5VideoStore


def to_rgb_video(video: np.ndarray) -> np.ndarray:
    """A clip as (T, H, W, 3) float32: (T, H, W) gray, (T, 1|3, H, W)
    channels-first and (T, H, W, 1|3) channels-last are accepted."""
    if video.ndim == 3:
        video = np.repeat(video[..., None], 3, axis=-1)
    elif video.shape[1] in (1, 3) and video.ndim == 4 and video.shape[-1] not in (1, 3):
        video = np.transpose(video, (0, 2, 3, 1))
        if video.shape[-1] == 1:
            video = np.repeat(video, 3, axis=-1)
    elif video.shape[-1] == 1:
        video = np.repeat(video, 3, axis=-1)
    return np.ascontiguousarray(video, dtype=np.float32)


class VideoDataset:
    """``VideoDataset(data, type, ...)``: `data` is a directory of
    ``<type>/`` HDF5 shards (a path holding "UCF": one store with the
    num_train / num_test attributes), or a store object such as an
    ``InMemoryVideoStore``, which is used as it is (its ``name`` selects UCF).
    Items are (clip, video_index): the clip in the stored layout, float32 in
    [0, 1], or the stored integers with ``raw_uint8``. ``cache_mb``: the RAM
    clip cache budget of the HDF5 store it opens (``HDF5VideoStore``)."""

    def __init__(self, data: Union[str, object], type: str = "train", total_videos: int = -1,
                 num_frames: int = 40, image_size: int = 64, random_time: bool = True,
                 random_horizontal_flip: bool = False, seed: int = 0, raw_uint8: bool = False,
                 cache_mb: int = 0):
        self.type = type
        self.num_frames = num_frames
        self.image_size = image_size
        self.total_videos = total_videos
        self.random_time = random_time
        self.random_horizontal_flip = random_horizontal_flip
        self.raw_uint8 = raw_uint8
        self.rng = np.random.RandomState(seed)
        if isinstance(data, (str, os.PathLike)):
            data = str(data)
            self.is_ucf = "UCF" in data
            self.store = HDF5VideoStore(data if self.is_ucf else os.path.join(data, type),
                                        cache_mb=cache_mb)
        else:
            if cache_mb:
                raise ValueError("cache_mb is the budget of an HDF5 store the dataset opens; "
                                 "a store given as it is keeps its own")
            self.store = data
            self.is_ucf = "UCF" in getattr(data, "name", "")
        if self.is_ucf:
            self.num_train_vids = int(self.store.attr("num_train"))
            # every 10th test video: the Mathieu et al. protocol
            self.num_test_vids = int(self.store.attr("num_test")) // 10

    def __len__(self) -> int:
        return self.total_videos if self.total_videos > 0 else self.max_index()

    def max_index(self) -> int:
        if self.is_ucf:
            return self.num_train_vids if self.type == "train" else self.num_test_vids
        return len(self.store)

    def _resolve_video_index(self, index: int) -> int:
        n = len(self)
        video_index = round(index / (n - 1) * (self.max_index() - 1)) if n > 1 else 0
        if self.is_ucf and self.type != "train":
            video_index = video_index * 10 + self.num_train_vids
        return video_index

    def __getitem__(self, index: int, time_idx: int = 0) -> Tuple[np.ndarray, int]:
        video_index = self._resolve_video_index(index)
        total = self.store.video_length(video_index)
        if self.random_time and total > self.num_frames:
            time_idx = int(self.rng.choice(total - self.num_frames))
        frames = self.store.read_frames(video_index, time_idx, self.num_frames)
        if self.is_ucf:
            full_w = int(self.image_size / 240 * 320)
            if self.type == "train":
                crop_c = int(self.rng.randint(full_w - self.image_size))
            else:
                crop_c = int((full_w - self.image_size) / 2)
            frames = frames[:, :, crop_c:crop_c + self.image_size]
            if self.random_horizontal_flip and self.rng.randint(2) == 0:
                frames = frames[:, :, ::-1]
        if self.raw_uint8 and np.issubdtype(frames.dtype, np.integer):
            return np.ascontiguousarray(frames), video_index
        return frames.astype(np.float32) / 255.0, video_index

    def prefill_cache(self) -> int:
        """Fill the store's RAM clip cache (``HDF5VideoStore.prefill_cache``);
        the number of videos cached."""
        return self.store.prefill_cache()
