"""Port data feed (extdm_tpu_torch.data) against the JAX package's, on the CPU.

The JAX package writes the HDF5 shards (``write_video_hdf5``,
``HDF5VideoWriter``); the port reads them, and its in-memory store holds the
same videos. Every comparison is exact: stores, clips, indices, batch order
(shuffle seed, ``drop_last``) and the canonicalisation the card does
(``canonicalize_clips`` against ``to_rgb_video(clip / 255)``).
"""
import sys

import numpy as np
import pytest
import torch

from extdm_tpu import data as jd
from extdm_tpu_torch import data


@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    jd.make_moving_shapes_dataset(str(root), num_train=3, num_valid=5, num_frames=12,
                                  image_size=32, seed=3)
    return root


def test_stores_match_jax(shapes_root):
    mem = data.make_moving_shapes_dataset(num_train=3, num_valid=5, num_frames=12,
                                          image_size=32, seed=3)
    for split, n in (("train", 3), ("valid", 5)):
        want = jd.HDF5VideoStore(str(shapes_root / split))
        got = data.HDF5VideoStore(str(shapes_root / split))
        assert len(got) == len(want) == len(mem[split]) == n
        for idx in range(n + 2):  # indices wrap around
            assert got.video_length(idx) == want.video_length(idx) == mem[split].video_length(idx)
            for start, num in ((0, 12), (3, 5), (9, 6)):
                w = want.read_frames(idx, start, num)
                np.testing.assert_array_equal(got.read_frames(idx, start, num), w)
                np.testing.assert_array_equal(mem[split].read_frames(idx, start, num), w)
        assert got.attr("num_train") is None
        got.close()


@pytest.mark.parametrize("raw", [False, True])
def test_video_dataset_matches_jax(shapes_root, raw):
    kw = dict(type="valid", total_videos=3, num_frames=8, image_size=32, random_time=True,
              seed=5, raw_uint8=raw)
    want = jd.VideoDataset(str(shapes_root), **kw)
    got = data.VideoDataset(str(shapes_root), **kw)
    mem = data.VideoDataset(data.make_moving_shapes_dataset(
        num_train=3, num_valid=5, num_frames=12, image_size=32, seed=3)["valid"], **kw)
    assert len(got) == len(want) == len(mem) == 3
    for i in (0, 1, 2, 1):
        (w, wi), (g, gi), (m, mi) = want[i], got[i], mem[i]
        assert gi == wi == mi and g.dtype == w.dtype == m.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(m, w)


@pytest.mark.parametrize("split", ["train", "test"])
def test_ucf_protocol_matches_jax(tmp_path, split):
    """UCF: the store's num_train / num_test, every 10th test video, the
    random (train) or centre (test) crop of the 4:3 frames, the flip."""
    rng = np.random.RandomState(6)
    videos = rng.randint(0, 256, size=(16, 9, 32, 42, 3)).astype(np.uint8)
    root = tmp_path / "UCF101"
    writer = jd.HDF5VideoWriter(str(root))
    for v in videos:
        writer.add_video(list(v))
    writer.set_scalar("num_train", 4)
    writer.set_scalar("num_test", 20)
    writer.close()
    kw = dict(type=split, num_frames=6, image_size=32, random_time=True,
              random_horizontal_flip=True, seed=7)
    want = jd.VideoDataset(str(root), **kw)
    got = data.VideoDataset(str(root), **kw)
    mem = data.VideoDataset(data.InMemoryVideoStore(videos, name="UCF101",
                                                    attrs={"num_train": 4, "num_test": 20}), **kw)
    assert len(got) == len(want) == len(mem) == (4 if split == "train" else 2)
    for i in list(range(len(want))) * 2:
        (w, wi), (g, gi), (m, mi) = want[i], got[i], mem[i]
        assert gi == wi == mi
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(m, w)


def test_to_rgb_video_and_canonicalize_clips_match_jax():
    rng = np.random.RandomState(8)
    for shape in ((2, 5, 6, 7), (2, 5, 1, 6, 7), (2, 5, 3, 6, 7), (2, 5, 6, 7, 1),
                  (2, 5, 6, 7, 3)):
        clips = rng.randint(0, 256, size=shape).astype(np.uint8)
        want = np.stack([jd.to_rgb_video(c / np.float32(255.0)) for c in clips])
        np.testing.assert_array_equal(np.stack([data.to_rgb_video(c / np.float32(255.0))
                                                for c in clips]), want)
        got = data.canonicalize_clips(torch.from_numpy(clips))
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    # float clips (the dataset without raw_uint8) are only laid out
    clip = rng.rand(2, 5, 6, 7).astype(np.float32)
    np.testing.assert_array_equal(data.canonicalize_clips(torch.from_numpy(clip)).numpy(),
                                  np.stack([jd.to_rgb_video(c) for c in clip]))


class _Items:
    """Items (array, index) with the dataset's own RandomState draws."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 3), i, np.uint8), i


@pytest.mark.parametrize("shuffle,drop_last,workers", [(True, True, 4), (True, False, 0),
                                                        (False, False, 2)])
def test_loader_order_matches_jax(shuffle, drop_last, workers):
    kw = dict(batch_size=3, shuffle=shuffle, num_workers=workers, drop_last=drop_last, seed=11)
    want = jd.DataLoader(_Items(10), **kw)
    got = data.DataLoader(_Items(10), **kw)
    assert len(got) == len(want) == (3 if drop_last else 4)
    for _ in range(2):  # two epochs: the shuffle state carries over
        wb, gb = list(want), list(got)
        assert len(gb) == len(wb)
        for (wa, wi), (ga, gi) in zip(wb, gb):
            np.testing.assert_array_equal(ga, wa)
            np.testing.assert_array_equal(gi, wi)
    on_cpu = list(data.DataLoader(_Items(10), device="cpu", **kw))  # a new loader: epoch 1
    for (wa, wi), (ta, ti) in zip(jd.DataLoader(_Items(10), **kw), on_cpu):
        assert torch.is_tensor(ta) and ta.dtype == torch.uint8
        np.testing.assert_array_equal(ta.numpy(), wa)
        np.testing.assert_array_equal(ti.numpy(), wi)
    assert got.wait_s >= 0.0


def test_loader_and_store_refusals(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="'thread' or 'process'"):
        data.DataLoader(_Items(4), 2, worker_type="spawn")
    with pytest.raises(ValueError, match="get_batch"):
        data.DataLoader(_Items(4), 2, batch_items=True)

    def no_fork(method):
        raise ValueError(f"cannot find context for {method!r}")

    monkeypatch.setattr(data.loader.multiprocessing, "get_context", no_fork)
    with pytest.raises(RuntimeError, match="no fork"):  # no silent fallback to threads
        data.DataLoader(_Items(4), 2, worker_type="process")
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            data.DataLoader(_Items(4), 2, device="cuda")

    class Broken(_Items):
        def __getitem__(self, i):
            raise KeyError(i)

    with pytest.raises(KeyError):  # an item's error reaches the consumer
        list(data.DataLoader(Broken(4), 2, num_workers=0))
    monkeypatch.setitem(sys.modules, "h5py", None)  # as on a machine without h5py
    with pytest.raises(ImportError, match="h5py"):
        data.HDF5VideoStore(str(tmp_path))
