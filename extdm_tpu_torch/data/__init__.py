"""Video data: stores (HDF5 or in memory), the clip and pair datasets and the loader."""
from extdm_tpu_torch.data.h5 import HDF5VideoStore
from extdm_tpu_torch.data.loader import DataLoader, canonicalize_clips, default_collate
from extdm_tpu_torch.data.synthetic import (
    InMemoryVideoStore,
    make_moving_shapes_dataset,
    make_moving_shapes_video,
)
from extdm_tpu_torch.data.two_frames import DatasetRepeater, TwoFramesDataset
from extdm_tpu_torch.data.video_dataset import VideoDataset, to_rgb_video

__all__ = ["HDF5VideoStore", "DataLoader", "canonicalize_clips", "default_collate",
           "InMemoryVideoStore", "make_moving_shapes_dataset", "make_moving_shapes_video",
           "VideoDataset", "to_rgb_video", "DatasetRepeater", "TwoFramesDataset"]
