"""Videos held in memory, the seeded moving-shapes videos and their HDF5
shards (port of extdm_tpu/data/synthetic.py).

``InMemoryVideoStore`` has the read API of ``HDF5VideoStore`` over numpy
arrays: the card's machine has no h5py, so its data is made there, from a
seed, and fed through the same ``VideoDataset`` and ``DataLoader``.
``make_moving_shapes_dataset`` draws the same videos, in the same order, as
the JAX package's, which writes them to HDF5 shards;
``write_moving_shapes_dataset`` writes them so (``write_video_hdf5``).
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np


class InMemoryVideoStore:
    """Videos (each (T, H, W[, C]) uint8, any lengths) with the read API of
    ``HDF5VideoStore``: ``video_length``, ``read_frames``, ``attr``.
    ``name`` stands in for the data path (a name holding "UCF" selects the
    UCF protocol in ``VideoDataset``)."""

    def __init__(self, videos: Sequence[np.ndarray], name: str = "memory",
                 attrs: Optional[Dict[str, object]] = None):
        self.videos = [np.asarray(v) for v in videos]
        if not self.videos:
            raise ValueError("an InMemoryVideoStore needs at least one video")
        self.name = name
        self.attrs = dict(attrs or {})
        self.total_num = len(self.videos)

    def __len__(self) -> int:
        return self.total_num

    def video_length(self, idx: int) -> int:
        return len(self.videos[idx % self.total_num])

    def read_frames(self, idx: int, start: int, num: int) -> np.ndarray:
        return self.videos[idx % self.total_num][start:start + num]

    def attr(self, name: str):
        return self.attrs.get(name)

    def prefill_cache(self, max_videos: Optional[int] = None) -> int:
        """The videos are in memory already: nothing to cache."""
        return 0


def _make_sprite(rng: np.random.RandomState, size: int = 12) -> np.ndarray:
    """A random digit-like blob sprite (H, W) uint8."""
    canvas = np.zeros((size, size), np.float32)
    for _ in range(rng.randint(2, 5)):
        x0, y0 = rng.randint(0, size - 4, size=2)
        w, h = rng.randint(2, max(3, size // 2), size=2)
        canvas[y0:y0 + h, x0:x0 + w] = rng.uniform(0.6, 1.0)
    return (canvas * 255).astype(np.uint8)


def make_moving_shapes_video(rng: np.random.RandomState, num_frames: int = 30,
                             image_size: int = 64, num_sprites: int = 2,
                             sprite_size: int = 12) -> np.ndarray:
    """(T, H, W) uint8 clip of sprites bouncing off the borders."""
    frames = np.zeros((num_frames, image_size, image_size), np.float32)
    hi = image_size - sprite_size
    for _ in range(num_sprites):
        sprite = _make_sprite(rng, sprite_size).astype(np.float32)
        pos = rng.uniform(0, hi, size=2)
        vel = rng.uniform(-3, 3, size=2)
        for t in range(num_frames):
            for d in range(2):
                if pos[d] < 0:
                    pos[d], vel[d] = -pos[d], -vel[d]
                if pos[d] > hi:
                    pos[d], vel[d] = 2 * hi - pos[d], -vel[d]
            y, x = int(round(pos[0])), int(round(pos[1]))
            patch = frames[t, y:y + sprite_size, x:x + sprite_size]
            frames[t, y:y + sprite_size, x:x + sprite_size] = np.maximum(patch, sprite)
            pos += vel
    return frames.clip(0, 255).astype(np.uint8)


def make_moving_shapes_dataset(num_train: int = 64, num_valid: int = 16, num_frames: int = 30,
                               image_size: int = 64,
                               seed: int = 0) -> Dict[str, InMemoryVideoStore]:
    """{"train": store, "valid": store} of moving-shapes clips drawn from one
    RandomState(seed), train first: the videos the JAX package's
    ``make_moving_shapes_dataset`` writes to ``<root>/train`` and
    ``<root>/valid``."""
    rng = np.random.RandomState(seed)
    stores = {}
    for split, n in (("train", num_train), ("valid", num_valid)):
        videos = [make_moving_shapes_video(rng, num_frames, image_size) for _ in range(n)]
        stores[split] = InMemoryVideoStore(videos, name=split)
    return stores


def write_video_hdf5(videos: Iterable[np.ndarray], out_dir: str, num_per_shard: int = 1000,
                     force: bool = True) -> int:
    """Videos (each (T, H, W[, C]) uint8) -> reference-layout shards in
    `out_dir`; returns how many were written."""
    from extdm_tpu_torch.data.h5 import HDF5VideoWriter

    writer = HDF5VideoWriter(out_dir, num_per_shard=num_per_shard, force=force)
    n = 0
    for vid in videos:
        writer.add_video(list(vid))
        n += 1
    writer.close()
    return n


def write_moving_shapes_dataset(root_dir: str, num_train: int = 64, num_valid: int = 16,
                                num_frames: int = 30, image_size: int = 64,
                                seed: int = 0) -> str:
    """``make_moving_shapes_dataset``'s videos as shards under
    ``<root_dir>/train`` and ``<root_dir>/valid``; returns root_dir."""
    stores = make_moving_shapes_dataset(num_train, num_valid, num_frames, image_size, seed)
    for split, store in stores.items():
        write_video_hdf5(store.videos, os.path.join(root_dir, split))
    return root_dir
