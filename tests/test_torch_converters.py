"""The port's dataset converters, auxiliary datasets and make_dataset
(extdm_tpu_torch.data.converters / base / make_dataset) against the JAX
package's, on the CPU, on inputs built in tmp_path as tests/test_converters.py
builds them: MNIST idx files (raw and gzip), hand-framed TFRecords, KTH avi
names, cityscapes PNGs, UCF split lists, a frame tree and an .npy array.
Every comparison is exact.

``make_dataset.main`` runs every subcommand in-process; its shards equal
those that scripts/make_dataset.py writes from the same inputs (run in a
subprocess, as tests/test_scripts.py runs it), read through the JAX store.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from extdm_tpu.data import HDF5VideoStore as JStore
from extdm_tpu.data import base as jbase
from extdm_tpu.data import converters as jconv
from extdm_tpu.data import write_video_hdf5 as j_write_video_hdf5
from extdm_tpu_torch.data import base, converters, make_dataset
from test_converters import (_example, _feature_bytes, _feature_floats, _feature_ints,
                             _write_avi, _write_idx, _write_tfrecord)

REPO = Path(__file__).resolve().parents[1]


def assert_same(got, want):
    """Equal values of the same types, nested through lists, tuples and dicts."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert got == want


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every converter's input, built once."""
    import cv2

    root = tmp_path_factory.mktemp("inputs")
    rs = np.random.RandomState(0)
    digits = rs.randint(0, 256, (10, 28, 28), dtype=np.uint8)
    _write_idx(str(root / "mnist-idx3-ubyte"), digits)
    import gzip
    import struct

    with gzip.open(root / "mnist-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 10, 28, 28) + digits.tobytes())
    # BAIR: two trajectories of 4 frames, with actions beside the images
    (root / "bair").mkdir()
    records = []
    for _ in range(2):
        v = rs.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8)
        feats = {}
        for t in range(4):
            feats[f"{t}/image_aux1/encoded"] = _feature_bytes([v[t].tobytes()])
            feats[f"{t}/action"] = _feature_floats([0.5, -1.0])
            feats[f"{t}/step"] = _feature_ints([t, 300])
        records.append(_example(feats))
    _write_tfrecord(str(root / "bair" / "traj_0_to_1.tfrecords"), records[:1])
    _write_tfrecord(str(root / "bair" / "traj_2_to_3.tfrecords"), records[1:])
    # KTH: flat and per-action avis, one name outside the split
    (root / "kth" / "boxing").mkdir(parents=True)
    for name in ("boxing/person01_boxing_d1_uncomp.avi", "boxing/person22_boxing_d2_uncomp.avi",
                 "person05_walking_d3_uncomp.avi", "person30_walking_d1_uncomp.avi"):
        _write_avi(root / "kth" / name, rs.randint(0, 256, (4, 120, 160), dtype=np.uint8))
    # cityscapes: two snippets of 3 frames in train, one in val, 2:1 frames
    for split, seqs in (("train", ("000000", "000001")), ("val", ("000007",))):
        city = root / "cityscapes" / split / "aachen"
        city.mkdir(parents=True)
        for seq in seqs:
            for t in range(3):
                cv2.imwrite(str(city / f"aachen_{seq}_{t:06d}_leftImg8bit.png"),
                            rs.randint(0, 256, (40, 80, 3), dtype=np.uint8))
    # UCF-101: three avis, split lists with labels (train) and a Windows path
    (root / "ucf" / "Biking").mkdir(parents=True)
    (root / "splits").mkdir()
    names = [f"Biking/v_Biking_g0{i}_c01.avi" for i in range(3)]
    for n in names:
        _write_avi(root / "ucf" / n, rs.randint(0, 256, (3, 48, 64), dtype=np.uint8))
    (root / "splits" / "trainlist01.txt").write_text(f"{names[0]} 1\r\n{names[1]} 1\r\n")
    (root / "splits" / "testlist01.txt").write_text(names[2].replace("/", "\\") + "\n")
    # a frame tree (RGB and gray frames, one unreadable file) and an array
    for v in range(2):
        d = root / "frames" / f"video{v}"
        d.mkdir(parents=True)
        for t in range(3):
            cv2.imwrite(str(d / f"{t:03d}.png"), rs.randint(0, 256, (40, 40, 3), np.uint8))
        (d / "notes.txt").write_text("not a frame")
    np.save(root / "clips.npy", rs.uniform(0, 1, (3, 4, 16, 16)).astype(np.float32))
    return root


# ------------------------------------------------------------- converters
CONVERTERS = {
    "load_mnist_images": lambda m, r: m.load_mnist_images(str(r / "mnist-idx3-ubyte")),
    "load_mnist_images_gz": lambda m, r: m.load_mnist_images(str(r / "mnist-idx3-ubyte.gz")),
    "make_smmnist": lambda m, r: list(m.make_smmnist(
        m.load_mnist_images(str(r / "mnist-idx3-ubyte")), num_videos=4, num_frames=15,
        image_size=48, num_digits=3, max_speed=6, seed=4)),
    "decode_video_file": lambda m, r: m.decode_video_file(
        str(r / "kth" / "person05_walking_d3_uncomp.avi")),
    "decode_video_file_gray_size": lambda m, r: m.decode_video_file(
        str(r / "kth" / "person05_walking_d3_uncomp.avi"), size=(30, 50), gray=True),
    "decode_video_file_missing": lambda m, r: m.decode_video_file(str(r / "none.avi")),
    "kth_split": lambda m, r: [m.kth_split(n) for n in (
        "person01_boxing_d1_uncomp.avi", "/x/person20_running_d4_uncomp.avi",
        "person21_walking_d1_uncomp.avi", "person25_jogging_d2_uncomp.avi",
        "person26_jogging_d2_uncomp.avi", "personXY.avi", "README.txt")],
    "iter_kth_videos": lambda m, r: list(m.iter_kth_videos(str(r / "kth"), image_size=32)),
    "iter_cityscapes_videos": lambda m, r: [list(m.iter_cityscapes_videos(
        str(r / "cityscapes"), split, image_size=16, snippet_len=2)) for split in ("train", "val")],
    "read_ucf_split_list": lambda m, r: [m.read_ucf_split_list(str(r / "splits"), s)
                                         for s in ("train", "test")],
    "iter_ucf101_videos": lambda m, r: list(m.iter_ucf101_videos(
        str(r / "ucf"), str(r / "splits"), image_size=24)),
    "iter_tfrecords": lambda m, r: list(m.iter_tfrecords(
        str(r / "bair" / "traj_0_to_1.tfrecords"))),
    "parse_tf_example": lambda m, r: [m.parse_tf_example(rec) for rec in m.iter_tfrecords(
        str(r / "bair" / "traj_2_to_3.tfrecords"))],
    "read_varint": lambda m, r: [m._read_varint(b"\x96\x01\xff\xff\x03\x05", p)
                                 for p in (0, 2, 5)],
    "iter_bair_videos": lambda m, r: list(m.iter_bair_videos(str(r / "bair"))),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_matches_jax(inputs, name):
    fn = CONVERTERS[name]
    assert_same(fn(converters, inputs), fn(jconv, inputs))


@pytest.mark.parametrize("call", [
    lambda m, r: m.load_mnist_images(str(r / "clips.npy")),
    lambda m, r: list(m.iter_kth_videos(str(r / "cityscapes"))),
    lambda m, r: list(m.iter_cityscapes_videos(str(r / "kth"), "train")),
    lambda m, r: list(m.iter_bair_videos(str(r / "kth")))], ids=["idx", "kth", "city", "bair"])
def test_converters_refuse_bad_inputs(inputs, call):
    """Where JAX asserts, the port raises (an assert vanishes under -O)."""
    with pytest.raises(AssertionError):
        call(jconv, inputs)
    with pytest.raises((ValueError, FileNotFoundError)):
        call(converters, inputs)


# ------------------------------------------------------------ base datasets
def test_concat_and_video_paths_match_jax():
    for mod in (base, jbase):
        cat = mod.ConcatDatasetWithIndex([[0, 1, 2], [10, 11]])
        assert len(cat) == 5 and cat.cumulative_sizes == [3, 5]
        assert [cat[i] for i in (0, 2, 3, 4, -1, -5)] == [(0, 0), (2, 0), (10, 1), (11, 1),
                                                          (11, 1), (0, 0)]
        with pytest.raises(ValueError):
            cat[-6]
    frames = np.random.RandomState(0).randint(0, 255, size=(6, 8, 8, 3), dtype=np.uint8)
    kw = dict(paths=["a", "b"], start_idxs=[1, 0], end_idxs=[4, 6], labels={"cls": [7, 9]},
              trans=lambda f: f[::2, ::2], reader=lambda path: frames[::-1] if path == "b"
              else frames)
    got, want = base.VideoPaths(**kw), jbase.VideoPaths(**kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_same(got[i], want[i])
    avi = "no-such-video.avi"
    with pytest.raises(Exception) as jerr:
        jbase.read_video_file(avi)
    with pytest.raises(jerr.type):
        base.read_video_file(avi)


@pytest.mark.parametrize("kw", [
    dict(frames_per_sample=5, random_time=True, seed=0),
    dict(frames_per_sample=4, random_time=True, total_videos=3, start_at=2, hflip=True, seed=3,
         labels={"tag": "x"}),
    dict(frames_per_sample=12, random_time=False, total_videos=2)], ids=["random", "hflip", "long"])
def test_hdf5_interface_matches_jax(tmp_path, kw):
    rng = np.random.RandomState(0)
    vids = rng.randint(0, 255, size=(4, 9, 8, 8), dtype=np.uint8)
    j_write_video_hdf5(vids, str(tmp_path / "h5"), num_per_shard=3)
    got = base.HDF5InterfaceDataset(str(tmp_path / "h5"), **kw)
    want = jbase.HDF5InterfaceDataset(str(tmp_path / "h5"), **kw)
    assert len(got) == len(want) and got.max_index() == want.max_index()
    assert [got.len_of_vid(i) for i in range(4)] == [want.len_of_vid(i) for i in range(4)]
    for i in list(range(len(want))) * 2:
        assert_same(got[i], want[i])
    assert_same(got.__getitem__(1, time_idx=2), want.__getitem__(1, time_idx=2))


# ------------------------------------------------------------- make_dataset
def subcommands(r, out):
    """{name: argv} of every subcommand on the fixture's inputs, writing under `out`."""
    return {
        "shapes": ["shapes", "--out", f"{out}/shapes", "--num_train", "3", "--num_valid", "2",
                   "--num_frames", "6", "--image_size", "24", "--seed", "5"],
        "frames": ["frames", "--src", f"{r}/frames", "--out", f"{out}/frames",
                   "--image_size", "32"],
        "npy": ["npy", "--src", f"{r}/clips.npy", "--out", f"{out}/npy", "--split", "valid"],
        "videos": ["videos", "--src", f"{r}/kth", "--out", f"{out}/videos", "--image_size", "24",
                   "--gray"],
        "smmnist": ["smmnist", "--mnist_images", f"{r}/mnist-idx3-ubyte.gz", "--out",
                    f"{out}/smmnist", "--num_videos", "3", "--num_frames", "8",
                    "--image_size", "40", "--seed", "2"],
        "bair": ["bair", "--src", f"{r}/bair", "--out", f"{out}/bair"],
        "kth": ["kth", "--src", f"{r}/kth", "--out", f"{out}/kth", "--image_size", "16"],
        "cityscapes": ["cityscapes", "--src", f"{r}/cityscapes", "--out", f"{out}/cityscapes",
                       "--image_size", "16"],
        "ucf101": ["ucf101", "--src", f"{r}/ucf", "--splits_dir", f"{r}/splits", "--out",
                   f"{out}/ucf101/UCF101", "--image_size", "24"],
    }


@pytest.fixture(scope="module")
def jax_shards(inputs, tmp_path_factory):
    """scripts/make_dataset.py's output for every subcommand, from one
    subprocess that runs the script once per subcommand."""
    out = tmp_path_factory.mktemp("jax_out")
    runs = json.dumps(list(subcommands(inputs, out).values()))
    driver = ("import json, runpy, sys\n"
              f"for argv in json.loads({runs!r}):\n"
              "    sys.argv = ['make_dataset.py'] + argv\n"
              "    runpy.run_path('scripts/make_dataset.py', run_name='__main__')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", driver], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return out


def stores_under(path):
    """{relative dir: JAX store} of every directory of shards under `path`."""
    dirs = sorted({p.parent for p in Path(path).rglob("*.hdf5")})
    return {str(d.relative_to(path)): JStore(str(d)) for d in dirs}


@pytest.mark.parametrize("cmd", list(subcommands("", "")))
def test_make_dataset_matches_jax_script(inputs, jax_shards, tmp_path, cmd, capsys):
    argv = subcommands(inputs, tmp_path)[cmd]
    assert make_dataset.main(argv) == 0
    assert "wrote" in capsys.readouterr().out or cmd == "shapes"
    got, want = stores_under(tmp_path / cmd), stores_under(jax_shards / cmd)
    assert list(got) == list(want) and want
    for split, w in want.items():
        g = got[split]
        assert [p.name for p in map(Path, g.shard_paths)] == [
            p.name for p in map(Path, w.shard_paths)]
        assert len(g) == len(w) > 0
        for name in ("num_train", "num_test"):
            assert g.attr(name) == w.attr(name)
        for i in range(len(w)):
            n = w.video_length(i)
            assert g.video_length(i) == n
            assert_same(g.read_frames(i, 0, n), w.read_frames(i, 0, n))
        g.close()
        w.close()
