"""Dataset converters (port of extdm_tpu/data/converters.py): the formats
the reference's README documents converters for, which need real parsing.
``data/make_dataset.py`` writes what they yield as HDF5 shards.

- Stochastic Moving MNIST from raw MNIST idx files (optionally gzip): two
  digits fly over a 64 x 64 canvas and draw a new direction and speed at
  every wall contact (Denton & Fergus 2018).
- Video files decoded with cv2 (``decode_video_file``).
- KTH avis with the person split of the reference's dataset table (479
  train / 120 test videos: persons 01-20 train, 21-25 test).
- Cityscapes leftImg8bit_sequence 30-frame png snippets (centre width-crop
  to a square, area resize).
- UCF-101 avis with the ucfTrainTestlist splits, in the one-store layout of
  ``VideoDataset``'s UCF branch (train videos first, num_train / num_test
  scalars; frames kept at 240:320 so the loader's width crop applies).
- BAIR robot-push TFRecords through a TFRecord and protobuf wire-format
  reader of its own (no tensorflow).

cv2 is imported by the functions that use it. Each function draws the same
values from the same seed as the JAX package's.
"""
from __future__ import annotations

import glob
import gzip
import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

# --------------------------------------------------------------- MNIST idx


def load_mnist_images(path: str) -> np.ndarray:
    """Parse an MNIST images idx3-ubyte file (optionally .gz) -> (N, 28, 28)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: not an idx3-ubyte images file (magic {magic})")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def make_smmnist(
    images: np.ndarray,
    num_videos: int,
    num_frames: int,
    image_size: int = 64,
    num_digits: int = 2,
    max_speed: int = 4,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Yield (T, H, W) uint8 stochastic-moving-MNIST videos.

    Deterministic straight-line motion; on wall contact the digit picks a
    new random direction and speed (the 'stochastic' part).
    """
    rs = np.random.RandomState(seed)
    digit_hw = images.shape[1]
    lim = image_size - digit_hw
    for _ in range(num_videos):
        idx = rs.randint(0, images.shape[0], size=num_digits)
        digits = images[idx]
        pos = rs.randint(0, lim + 1, size=(num_digits, 2)).astype(np.int64)
        theta = rs.uniform(0, 2 * np.pi, size=num_digits)
        speed = rs.randint(1, max_speed + 1, size=num_digits)
        vel = np.stack([np.cos(theta), np.sin(theta)], axis=1) * speed[:, None]
        video = np.zeros((num_frames, image_size, image_size), np.uint8)
        fpos = pos.astype(np.float64)
        for t in range(num_frames):
            for d in range(num_digits):
                nxt = fpos[d] + vel[d]
                bounced = False
                for ax in range(2):
                    if nxt[ax] < 0 or nxt[ax] > lim:
                        bounced = True
                if bounced:
                    # clamp to the wall, then re-randomize direction+speed
                    fpos[d] = np.clip(nxt, 0, lim)
                    th = rs.uniform(0, 2 * np.pi)
                    sp = rs.randint(1, max_speed + 1)
                    vel[d] = np.array([np.cos(th), np.sin(th)]) * sp
                else:
                    fpos[d] = nxt
                y, x = int(round(fpos[d][0])), int(round(fpos[d][1]))
                patch = video[t, y : y + digit_hw, x : x + digit_hw]
                np.maximum(patch, digits[d], out=patch)
        yield video


# ---------------------------------------------------------- video files


def decode_video_file(
    path: str,
    size: Tuple[int, int] | None = None,
    gray: bool = False,
) -> np.ndarray:
    """cv2-decode a video file -> (T, H, W[, C]) uint8, RGB (or gray).

    `size` = (height, width) target, area-interpolated."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        code = cv2.COLOR_BGR2GRAY if gray else cv2.COLOR_BGR2RGB
        frame = cv2.cvtColor(frame, code)
        if size is not None and frame.shape[:2] != size:
            frame = cv2.resize(frame, (size[1], size[0]),
                               interpolation=cv2.INTER_AREA)
        frames.append(frame.astype(np.uint8))
    cap.release()
    if not frames:
        return np.zeros((0,), np.uint8)
    return np.stack(frames)


# ----------------------------------------------------------------- KTH

KTH_ACTIONS = ("boxing", "handclapping", "handwaving", "jogging",
               "running", "walking")
# Person split matching the reference dataset table (README.md:71,
# 479 train / 120 test videos = 20/5 persons; one upstream train clip,
# person01_boxing_d4, is truncated/corrupt in the official download).
KTH_TRAIN_PERSONS = tuple(range(1, 21))
KTH_TEST_PERSONS = tuple(range(21, 26))


def kth_split(filename: str) -> str | None:
    """'person13_handclapping_d3_uncomp.avi' -> 'train' | 'test' | None."""
    base = os.path.basename(filename)
    if not base.startswith("person"):
        return None
    try:
        person = int(base[len("person"):len("person") + 2])
    except ValueError:
        return None
    if person in KTH_TRAIN_PERSONS:
        return "train"
    if person in KTH_TEST_PERSONS:
        return "test"
    return None


def iter_kth_videos(
    kth_dir: str, image_size: int = 64
) -> Iterator[Tuple[str, str, np.ndarray]]:
    """Yield (split, filename, (T, H, W) uint8 gray video) for every KTH
    avi under `kth_dir` (flat or per-action subdirs), person-split.

    Frames are resized 120x160 -> image_size square (the stored layout
    the reference's KTH h5 uses: VideoDataset reads them with no crop)."""
    files = sorted(
        glob.glob(os.path.join(kth_dir, "*.avi"))
        + glob.glob(os.path.join(kth_dir, "*", "*.avi"))
    )
    if not files:
        raise FileNotFoundError(f"no .avi files under {kth_dir}")
    for path in files:
        split = kth_split(path)
        if split is None:
            continue
        video = decode_video_file(path, size=(image_size, image_size),
                                  gray=True)
        if video.size:
            yield split, os.path.basename(path), video


# ---------------------------------------------------------- Cityscapes


def iter_cityscapes_videos(
    sequence_dir: str, split: str, image_size: int = 64, snippet_len: int = 30
) -> Iterator[np.ndarray]:
    """Yield (T, S, S, 3) uint8 videos from a leftImg8bit_sequence tree.

    Layout: <dir>/<split>/<city>/<city>_<seq>_<frame>_leftImg8bit.png in
    30-frame snippets. Frames are center width-cropped 1024x2048 -> square
    then area-resized (the reference table's 64px Cityscapes store)."""
    import cv2

    pattern = os.path.join(sequence_dir, split, "*", "*_leftImg8bit.png")
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no pngs match {pattern}")
    groups: Dict[Tuple[str, str], List[str]] = {}
    for f in files:
        city, seq = os.path.basename(f).split("_")[:2]
        groups.setdefault((city, seq), []).append(f)
    for key in sorted(groups):
        paths = sorted(groups[key])
        frames = []
        for p in paths[:snippet_len]:
            img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            h, w = img.shape[:2]
            if w > h:
                off = (w - h) // 2
                img = img[:, off:off + h]
            if img.shape[0] != image_size:
                img = cv2.resize(img, (image_size, image_size),
                                 interpolation=cv2.INTER_AREA)
            frames.append(img.astype(np.uint8))
        if frames:
            yield np.stack(frames)


# ------------------------------------------------------------- UCF-101


def read_ucf_split_list(splits_dir: str, split: str, split_id: int = 1) -> List[str]:
    """Parse ucfTrainTestlist train/testlist0<k>.txt -> relative avi paths
    ('<Class>/v_<Class>_g01_c01.avi'; trainlist lines carry a label)."""
    path = os.path.join(splits_dir, f"{split}list{split_id:02d}.txt")
    out = []
    with open(path) as f:
        for line in f:
            rel = line.strip().split()[0]
            if rel:
                out.append(rel.replace("\\", "/"))
    return out


def iter_ucf101_videos(
    ucf_dir: str, splits_dir: str, image_size: int = 64, split_id: int = 1
) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ('train'|'test', (T, H, W', 3) uint8) UCF-101 videos, train
    list first (the single-store layout `VideoDataset`'s UCF branch
    expects: num_train/num_test scalars, train-first ordering,
    video_dataset.py:55-62).

    Frames keep the native 240:320 aspect — stored at
    (image_size, image_size*320/240) so the loader's random/center
    width-crop to square applies (``VideoDataset``'s UCF branch)."""
    size = (image_size, int(round(image_size / 240 * 320)))
    for split in ("train", "test"):
        for rel in read_ucf_split_list(splits_dir, split, split_id):
            video = decode_video_file(os.path.join(ucf_dir, rel), size=size)
            if video.size:
                yield split, video


# ------------------------------------------------ BAIR: TFRecord, protobuf


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) for a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_tf_example(buf: bytes) -> Dict[str, list]:
    """Parse a serialized tf.train.Example into {key: [values...]}.

    Schema (tensorflow/core/example/{example,feature}.proto):
      Example{1: Features}; Features{1: map<string, Feature>} where each
      map entry is a message {1: key, 2: Feature};
      Feature{1: BytesList{1: bytes*}, 2: FloatList{1: float*},
              3: Int64List{1: int64*}} (float/int lists may be packed).
    """
    out: Dict[str, list] = {}
    for f, w, features in _iter_fields(buf):
        if f != 1 or w != 2:
            continue
        for f2, w2, entry in _iter_fields(features):
            if f2 != 1 or w2 != 2:
                continue
            key = None
            vals: list = []
            for f3, w3, payload in _iter_fields(entry):
                if f3 == 1 and w3 == 2:
                    key = payload.decode("utf-8")
                elif f3 == 2 and w3 == 2:
                    for f4, w4, flist in _iter_fields(payload):
                        if f4 == 1 and w4 == 2:  # BytesList
                            for f5, w5, b in _iter_fields(flist):
                                if f5 == 1 and w5 == 2:
                                    vals.append(b)
                        elif f4 == 2 and w4 == 2:  # FloatList (packed)
                            for f5, w5, b in _iter_fields(flist):
                                if f5 == 1:
                                    if w5 == 2:
                                        vals.extend(
                                            struct.unpack(f"<{len(b)//4}f", b))
                                    elif w5 == 5:
                                        vals.append(struct.unpack("<f", b)[0])
                        elif f4 == 3 and w4 == 2:  # Int64List
                            for f5, w5, v in _iter_fields(flist):
                                if f5 == 1 and w5 == 0:
                                    vals.append(v)
            if key is not None:
                out[key] = vals
    return out


def iter_tfrecords(path: str) -> Iterator[bytes]:
    """Yield raw records from a TFRecord file (length-prefixed framing;
    CRCs are skipped, not validated)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc
            data = f.read(length)
            if len(data) < length:
                return
            f.read(4)  # data crc
            yield data


def iter_bair_videos(
    src_dir: str,
    image_key: str = "image_aux1/encoded",
    image_shape: Tuple[int, int, int] = (64, 64, 3),
) -> Iterator[np.ndarray]:
    """Yield (T, 64, 64, 3) uint8 videos from a directory of BAIR
    tfrecords. Frames are stored as raw RGB bytes under keys
    '<t>/image_aux1/encoded' (the reference's converter reads the same
    key via tensorflow)."""
    files = sorted(glob.glob(os.path.join(src_dir, "*.tfrecord*")))
    if not files:
        files = sorted(
            f for f in glob.glob(os.path.join(src_dir, "*"))
            if os.path.isfile(f) and "tfrecord" in os.path.basename(f)
        )
    if not files:
        raise FileNotFoundError(f"no tfrecord files under {src_dir}")
    H, W, C = image_shape
    for path in files:
        for record in iter_tfrecords(path):
            ex = parse_tf_example(record)
            frames: List[np.ndarray] = []
            t = 0
            while f"{t}/{image_key}" in ex:
                raw = ex[f"{t}/{image_key}"][0]
                frames.append(
                    np.frombuffer(raw, np.uint8).reshape(H, W, C))
                t += 1
            if frames:
                yield np.stack(frames)
