"""Stage-1 pair sampler (port of extdm_tpu/data/two_frames.py): two frames of
a video at a distance within [min, max] (rejection sampling), gray to RGB,
the augmentation pipeline, and the repeat wrapper. Items are channels-last
float32 in [0, 1], or the stored integers with ``raw_uint8`` (the train step
canonicalises and augments on the device). Returns numpy;
``data/loader.py`` makes batches.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np

from extdm_tpu_torch.data.augmentation import AllAugmentationTransform
from extdm_tpu_torch.data.h5 import HDF5VideoStore


def gray2rgb(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 2:
        return np.repeat(frame[..., None], 3, axis=-1)
    if frame.shape[-1] == 1:
        return np.repeat(frame, 3, axis=-1)
    return frame


class TwoFramesDataset:
    """``TwoFramesDataset(data, type, ...)``: `data` is a directory of
    ``<type>/`` HDF5 shards (a path holding "UCF": one store with the
    num_train / num_test attributes), or a store object such as an
    ``InMemoryVideoStore``, used as it is (its ``name`` selects UCF), as
    ``VideoDataset`` takes it."""

    def __init__(self, data: Union[str, object], type: str = "train", total_videos: int = -1,
                 frame_shape: int = 64, min_frame_distance: int = 0,
                 max_frame_distance: int = 50, augmentation_params: Optional[dict] = None,
                 seed: int = 0, raw_uint8: bool = False):
        self.type = type
        self.total_videos = total_videos
        self.frame_shape = frame_shape
        self.min_frame_distance = min_frame_distance
        self.max_frame_distance = max_frame_distance
        self.rng = np.random.RandomState(seed)
        if isinstance(data, (str, os.PathLike)):
            data = str(data)
            self.is_ucf = "UCF" in data
            self.store = HDF5VideoStore(data if self.is_ucf else os.path.join(data, type))
        else:
            self.store = data
            self.is_ucf = "UCF" in getattr(data, "name", "")
        if self.is_ucf:
            self.num_train_vids = int(self.store.attr("num_train"))
            self.num_test_vids = int(self.store.attr("num_test")) // 10
        self.transform = (AllAugmentationTransform(**augmentation_params)
                          if type == "train" and augmentation_params else None)
        self.raw_uint8 = raw_uint8
        if raw_uint8 and self.transform is not None and not self.transform.batchable:
            raise ValueError("raw_uint8 needs a geometry-preserving augmentation pipeline "
                             "(flip and jitter only): crop, resize and rotation run on the host")

    def max_index(self) -> int:
        if self.is_ucf:
            return self.num_train_vids if self.type == "train" else self.num_test_vids
        return len(self.store)

    def __len__(self) -> int:
        return self.total_videos if self.total_videos > 0 else self.max_index()

    def _sample_pair(self, num_frames: int) -> np.ndarray:
        idxs = np.sort(self.rng.choice(num_frames, replace=True, size=2))
        for _ in range(1000):
            if self.min_frame_distance <= idxs[1] - idxs[0] <= self.max_frame_distance:
                break
            idxs = np.sort(self.rng.choice(num_frames, replace=True, size=2))
        return idxs

    def _video_index(self, index: int) -> int:
        n = len(self)
        video_index = round(index / (n - 1) * (self.max_index() - 1)) if n > 1 else 0
        if self.is_ucf and self.type != "train":
            video_index = video_index * 10 + self.num_train_vids
        return video_index

    def _read_pair(self, index: int, raw: bool):
        """(frames, frame indices) of item `index`, before augmentation."""
        video_index = self._video_index(index)
        frame_idxs = self._sample_pair(self.store.video_length(video_index))
        crop_c = None
        if self.is_ucf:
            full_w = int(self.frame_shape / 240 * 320)
            if self.type == "train":
                crop_c = int(self.rng.randint(full_w - self.frame_shape))
            else:
                crop_c = int((full_w - self.frame_shape) / 2)
        frames = []
        for fi in frame_idxs:
            frame = self.store.read_frames(video_index, int(fi), 1)[0]
            if crop_c is not None:
                frame = frame[:, crop_c:crop_c + self.frame_shape]
            if raw and np.issubdtype(frame.dtype, np.integer):
                frames.append(np.ascontiguousarray(frame))
                continue
            frame = gray2rgb(frame)
            if np.issubdtype(frame.dtype, np.integer):
                frame = frame.astype(np.float32) / 255.0
            frames.append(frame.astype(np.float32))
        return frames, frame_idxs

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        frames, frame_idxs = self._read_pair(index, self.raw_uint8)
        if self.raw_uint8 and frames[0].dtype == np.uint8:
            return {"source": frames[0], "driving": frames[1], "frame": np.asarray(frame_idxs),
                    "id": index}
        if self.transform is not None:
            frames = self.transform(frames)
        return {"source": np.ascontiguousarray(frames[0], np.float32),
                "driving": np.ascontiguousarray(frames[1], np.float32),
                "frame": np.asarray(frame_idxs), "id": index}

    def get_batch(self, indices) -> Dict[str, np.ndarray]:
        """A whole batch: every pair read, then the augmentation over the
        batch at once (``batch_call``, independent per-pair parameters) where
        the pipeline keeps the geometry, else pair by pair."""
        pairs, fidx = [], []
        for i in indices:
            frames, idxs = self._read_pair(int(i), False)
            pairs.append(np.stack(frames))
            fidx.append(idxs)
        clips = np.stack(pairs)  # (B, 2, H, W, 3)
        if self.transform is not None:
            if self.transform.batchable:
                clips = self.transform.batch_call(clips)
            else:
                clips = np.stack([np.stack(self.transform(list(c))) for c in clips])
        return {"source": np.ascontiguousarray(clips[:, 0], np.float32),
                "driving": np.ascontiguousarray(clips[:, 1], np.float32),
                "frame": np.stack(fidx), "id": np.asarray([int(i) for i in indices])}


class DatasetRepeater:
    """The dataset num_repeats times over per epoch."""

    def __init__(self, dataset, num_repeats: int = 100):
        self.dataset = dataset
        self.num_repeats = num_repeats

    def __len__(self):
        return self.num_repeats * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def get_batch(self, indices):
        n = len(self.dataset)
        return self.dataset.get_batch([int(i) % n for i in indices])
