"""The port's data feed against the JAX package's, on the CPU: the HDF5
shard writer, the RAM clip cache and the process loader
(extdm_tpu_torch.data.h5 / loader).

- Writer: shards written by either package read back equal through the
  other's store, with the same files, HDF5 keys, dtypes, compression, shard
  split and ``set_scalar`` value.
- Clip cache: at the same budget (JAX's ``EXTDM_CLIP_CACHE_MB``, the port's
  ``cache_mb``) the same prefill count and bitwise the same reads; cached
  videos are frozen; eight threads racing for one video read it once.
- Process loader: the same batches as JAX's ``worker_type="process"`` on
  the same seed (exact on raw clips; the pairs with the KTH yaml's flip and
  jitter within 1e-5, the bound of the port's augmentation tests); repeats
  across runs and worker counts; ships the same batches as tensors; a
  worker's exception reaches the consumer, a worker's death raises there
  (``BrokenProcessPool``); each rank of a 2-rank data group
  gets its rows of one process's batches; ``batch_items`` gives the
  whole-batch route's batches (JAX's ``EXTDM_BATCH_ITEMS=1``).

Every test that forks consumes its loaders in a thread joined with a timeout,
so a hung worker fails that test instead of stalling the suite.
"""
import contextlib
import os
import random
import sys
import threading
import time
from concurrent.futures.process import BrokenProcessPool
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from extdm_tpu import data as jd
from extdm_tpu_torch import data
from extdm_tpu_torch.data import loader as port_loader
from extdm_tpu_torch.parallel.mesh import DataGroup

REPO = Path(__file__).resolve().parents[1]
KTH_AUG = yaml.safe_load((REPO / "configs" / "AE" / "kth.yaml").read_text())["dataset_params"][
    "augmentation_params"]
WAIT_S = 120


def bounded(fn, timeout=WAIT_S):
    """fn() in a thread joined with a timeout: its value, or its exception."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test's thread below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"no result within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def epochs(loader, n=2):
    return bounded(lambda: [list(loader) for _ in range(n)])


def close_jax(loader):
    if loader.proc_pool is not None:
        loader.proc_pool.terminate()
        loader.proc_pool.join()


def assert_batches_equal(got, want, atol=0.0):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            g, w = [g[k] for k in sorted(w)], [w[k] for k in sorted(w)]
        for a, b in zip(g, w):
            a = a.numpy() if torch.is_tensor(a) else a
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ------------------------------------------------------------------ writer
def h5_layout(out_dir):
    """{shard file: {dataset path: (dtype, shape, compression, value)}}."""
    import h5py

    layout = {}
    for path in sorted(Path(out_dir).glob("*.hdf5")):
        entries = {}
        with h5py.File(path, "r") as f:
            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    entries[name] = (obj.dtype, obj.shape, obj.compression, obj[()])
                else:
                    entries[name] = "group"
            f.visititems(visit)
        layout[path.name] = entries
    return layout


@pytest.mark.parametrize("channels", [None, 3], ids=["gray", "rgb"])
def test_writer_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(0)
    shape = (12, 10) + ((channels,) if channels else ())
    videos = [rng.integers(0, 256, (n,) + shape, np.uint8) for n in (3, 5, 4, 6, 2)]
    for mod, name in ((jd, "jax"), (data, "port")):
        w = mod.HDF5VideoWriter(str(tmp_path / name), num_per_shard=2)
        for v in videos:
            w.add_video(list(v))
        w.set_scalar("num_train", 3)  # into shard 1 from shard 3
        w.set_scalar("num_train", 4)  # replaced
        w.close()
    want, got = h5_layout(tmp_path / "jax"), h5_layout(tmp_path / "port")
    assert list(got) == list(want) == ["shard_0001.hdf5", "shard_0002.hdf5", "shard_0003.hdf5"]
    for shard in want:
        assert got[shard].keys() == want[shard].keys()
        for key, w in want[shard].items():
            g = got[shard][key]
            if w == "group":
                assert g == "group", key
                continue
            assert g[:3] == w[:3], key
            np.testing.assert_array_equal(g[3], w[3])
    assert want["shard_0001.hdf5"]["num_train"][3] == 4
    assert want["shard_0001.hdf5"]["0/0"][2] == "lzf"
    # each package's store reads the other's shards
    for store, src in ((jd.HDF5VideoStore(str(tmp_path / "port")), "port"),
                       (data.HDF5VideoStore(str(tmp_path / "jax")), "jax")):
        assert len(store) == len(videos) and int(store.attr("num_train")) == 4, src
        for i, v in enumerate(videos):
            assert store.video_length(i) == len(v)
            np.testing.assert_array_equal(store.read_frames(i, 0, len(v)), v)
            np.testing.assert_array_equal(store.read_frames(i, 1, 2), v[1:3])
        store.close()
    with pytest.raises(ValueError, match="force=True"):
        data.HDF5VideoWriter(str(tmp_path / "jax"))
    data.HDF5VideoWriter(str(tmp_path / "jax"), force=True).close()
    assert [p.name for p in (tmp_path / "jax").glob("*.hdf5")] == ["shard_0001.hdf5"]


# -------------------------------------------------------------- clip cache
@pytest.fixture(scope="module")
def big_store(tmp_path_factory):
    """Five videos of 20 frames 128 x 128 x 3 (0.94 MiB each), one shard."""
    root = tmp_path_factory.mktemp("cache")
    rng = np.random.default_rng(1)
    videos = rng.integers(0, 256, (5, 20, 128, 128, 3), np.uint8)
    jd.write_video_hdf5(videos, str(root / "train"), num_per_shard=3)
    return str(root / "train"), videos


READS = [(0, 3, 5), (4, 0, 20), (2, 18, 5), (1, 7, 1), (3, 0, 2), (0, 0, 20), (4, 19, 3)]


@pytest.mark.parametrize("mb", [0, 2, 100])
@pytest.mark.parametrize("prefill", [True, False], ids=["prefill", "lazy"])
def test_clip_cache_matches_jax(big_store, monkeypatch, mb, prefill):
    path, videos = big_store
    monkeypatch.setenv("EXTDM_CLIP_CACHE_MB", str(mb))
    want, got = jd.HDF5VideoStore(path), data.HDF5VideoStore(path, cache_mb=mb)
    if prefill:
        n = got.prefill_cache()
        assert n == want.prefill_cache() == {0: 0, 2: 3, 100: 5}[mb]
        # again: the videos found cached count, until the budget is spent
        assert got.prefill_cache(max_videos=2) == want.prefill_cache(max_videos=2) \
            == {0: 0, 2: 0, 100: 2}[mb]
    for idx, start, num in READS:
        g, w = got.read_frames(idx, start, num), want.read_frames(idx, start, num)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, videos[idx][start:start + num])
        assert g.flags.writeable == w.flags.writeable
    assert got.cache_bytes == want._video_cache_bytes
    assert sorted(got._cache) == sorted(want._video_cache)
    if mb:  # cached videos are frozen: an in-place consumer fails loudly
        with pytest.raises(ValueError, match="read-only"):
            got.read_frames(0, 0, 2)[0, 0, 0] = 1
    assert data.InMemoryVideoStore(list(videos)).prefill_cache() == 0
    want.close()
    got.close()


def test_cache_fill_is_single_flight(big_store, monkeypatch):
    path, videos = big_store
    store = data.HDF5VideoStore(path, cache_mb=100)
    reads, lock = [], threading.Lock()
    read_range = store._read_range

    def counted(*args):
        with lock:
            reads.append(args)
        time.sleep(0.05)  # hold the fill open while the others arrive
        return read_range(*args)

    monkeypatch.setattr(store, "_read_range", counted)
    start = threading.Barrier(8)
    results = [None] * 8

    def reader(i):
        start.wait()
        results[i] = store.read_frames(1, i, 3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert reads == [(0, "1", 0, 20)]  # one read, of the whole video
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r, videos[1][i:i + 3])
        assert not r.flags.writeable
    store.close()


# ----------------------------------------------------------- process loader
@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("feed")
    jd.make_moving_shapes_dataset(str(root), num_train=6, num_valid=2, num_frames=14,
                                  image_size=32, seed=3)
    return str(root)


def clips(mod, root, seed=1):
    return mod.VideoDataset(root, num_frames=6, image_size=32, seed=seed)


def pairs(mod, root, seed=5):
    return mod.DatasetRepeater(mod.TwoFramesDataset(
        root, type="train", frame_shape=32, max_frame_distance=5, augmentation_params=KTH_AUG,
        seed=seed), 2)


@pytest.mark.parametrize("kind,atol", [("clips", 0.0), ("pairs", 1e-5)])
def test_process_loader_matches_jax(shapes_root, kind, atol):
    make = {"clips": clips, "pairs": pairs}[kind]
    kw = dict(batch_size=4 if kind == "pairs" else 2, num_workers=2, seed=7,
              worker_type="process")
    want_loader = jd.DataLoader(make(jd, shapes_root), **kw)
    got_loader = data.DataLoader(make(data, shapes_root), **kw)
    try:
        want, got = epochs(want_loader), epochs(got_loader)
    finally:
        close_jax(want_loader)
        got_loader.close()
    for g, w in zip(got, want):  # two epochs: the batch counter carries over
        assert_batches_equal(g, w, atol)
    assert got_loader.proc_pool is None  # closed


def test_process_loader_repeats_ships_and_reraises(shapes_root):
    runs = []
    for workers, device in ((1, None), (3, None), (2, "cpu")):
        loader = data.DataLoader(pairs(data, shapes_root), 4, num_workers=workers, seed=7,
                                 worker_type="process", device=device)
        with contextlib.closing(loader):
            runs.append(epochs(loader))
    for run in runs[1:]:
        for g, w in zip(run, runs[0]):
            assert_batches_equal(g, w)
    assert all(torch.is_tensor(v) for b in runs[2][0] for v in b.values())

    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError(f"item {i}")
            return np.full((2,), i, np.int64)

    with contextlib.closing(data.DataLoader(Broken(), 2, shuffle=False, num_workers=2,
                                            worker_type="process")) as loader:
        with pytest.raises(KeyError, match="item 5"):
            bounded(lambda: list(loader))

    class Dies(Broken):
        def __getitem__(self, i):
            if i == 3:
                os._exit(3)  # a worker lost mid-batch: an error, not a wait
            return super().__getitem__(i)

    with contextlib.closing(data.DataLoader(Dies(), 2, shuffle=False, num_workers=2,
                                            worker_type="process")) as loader:
        with pytest.raises(BrokenProcessPool):
            bounded(lambda: list(loader))


def test_process_loader_rank_rows_equal_one_process(shapes_root):
    kw = dict(num_workers=2, seed=7, worker_type="process")
    with contextlib.closing(data.DataLoader(pairs(data, shapes_root), 4, **kw)) as one:
        whole = epochs(one)
    for rank in range(2):
        group = DataGroup(size=2, rank=rank, world=None)
        with contextlib.closing(data.DataLoader(pairs(data, shapes_root), 4, group=group,
                                                **kw)) as loader:
            got = epochs(loader)
        for g, w in zip(got, whole):
            rows = [{k: v[2 * rank:2 * rank + 2] for k, v in b.items()} for b in w]
            assert_batches_equal(g, rows)


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_batch_items_gives_whole_batch_route(shapes_root, monkeypatch, worker_type):
    kw = dict(batch_size=4, num_workers=2, seed=7)
    if worker_type == "thread":  # JAX's opt-in whole-batch route
        monkeypatch.setenv("EXTDM_BATCH_ITEMS", "1")
        want = []
        for mod in (jd, data):
            extra = {"batch_items": True} if mod is data else {}
            loader = mod.DataLoader(pairs(mod, shapes_root), **kw, **extra)
            random.seed(9)
            np.random.seed(9)
            want.append(bounded(lambda: list(loader)))
        assert_batches_equal(want[1], want[0], atol=1e-5)
        return
    # process workers: each batch is get_batch after the worker's reseed
    with contextlib.closing(data.DataLoader(pairs(data, shapes_root), worker_type="process",
                                            batch_items=True, **kw)) as loader:
        got = epochs(loader)
    ref = data.DataLoader(pairs(data, shapes_root), **dict(kw, num_workers=0))
    seeds = iter(range(1, 99))
    for epoch in got:
        want = []
        for indices in ref._batches():
            port_loader._reseed_chain(ref.dataset, 7 * 1_000_003 + next(seeds))
            want.append(ref.dataset.get_batch(indices))
        assert_batches_equal(epoch, want)
