"""Dataset preparation: videos of several sources -> HDF5 shards in the
reference layout (port of scripts/make_dataset.py; the JAX package's store
reads them as it reads that script's).

    python -m extdm_tpu_torch.data.make_dataset shapes --out data/shapes
    python -m extdm_tpu_torch.data.make_dataset kth --src KTH/ --out data/KTH64_h5
    extdm-torch-make-dataset smmnist --mnist_images train-images-idx3-ubyte.gz --out ...

Subcommands: ``shapes`` (the seeded moving-shapes set, <out>/train and
<out>/valid), ``frames`` (a tree of per-video frame folders), ``npy`` (an
(N, T, H, W[, C]) .npy/.npz array), ``videos`` (video files, cv2), ``smmnist``
(Stochastic Moving MNIST from MNIST idx files), ``bair`` (BAIR push
TFRecords), ``kth`` (person split into <out>/train and <out>/test),
``cityscapes`` (leftImg8bit_sequence snippets) and ``ucf101`` (one store,
train first, with num_train / num_test). Needs h5py; ``frames``, ``videos``,
``kth``, ``cityscapes`` and ``ucf101`` need cv2.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Iterable

import numpy as np

VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".webm")


def write_videos(out_dir: str, videos: Iterable[np.ndarray]) -> int:
    """Each video as one entry of fresh shards in `out_dir`, split as the
    JAX script's HDF5VideoWriter splits them; returns how many were written."""
    from extdm_tpu_torch.data.synthetic import write_video_hdf5

    return write_video_hdf5(videos, out_dir, num_per_shard=100000)


def convert_frames_tree(src: str, out: str, image_size: int, split: str) -> None:
    """<src>/<video>/<frame>.png|jpg -> <out>/<split>: RGB (or as stored for
    gray), area-resized to image_size where it differs."""
    import cv2

    videos = sorted(d for d in glob.glob(os.path.join(src, "*")) if os.path.isdir(d))
    if not videos:
        raise FileNotFoundError(f"no video dirs under {src}")

    def frames_of(vdir):
        for fp in sorted(glob.glob(os.path.join(vdir, "*"))):
            img = cv2.imread(fp, cv2.IMREAD_UNCHANGED)
            if img is None:
                continue
            if img.ndim == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if image_size and img.shape[0] != image_size:
                img = cv2.resize(img, (image_size, image_size), interpolation=cv2.INTER_AREA)
            yield img.astype(np.uint8)

    write_videos(os.path.join(out, split),
                 (f for f in (list(frames_of(v)) for v in videos) if f))
    print(f"wrote {len(videos)} videos to {out}/{split}")


def convert_video_files(src: str, out: str, split: str, image_size: int, gray: bool) -> None:
    """Every video file under `src` (recursively, sorted) -> <out>/<split>,
    decoded by cv2, RGB or gray, area-resized to image_size where it differs."""
    import cv2

    files = sorted(f for f in glob.glob(os.path.join(src, "**", "*"), recursive=True)
                   if os.path.splitext(f)[1].lower() in VIDEO_EXTS)
    if not files:
        raise FileNotFoundError(f"no video files under {src}")

    def frames_of(path):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY if gray else cv2.COLOR_BGR2RGB)
            if image_size and frame.shape[0] != image_size:
                frame = cv2.resize(frame, (image_size, image_size),
                                   interpolation=cv2.INTER_AREA)
            frames.append(frame.astype(np.uint8))
        cap.release()
        return frames

    n = write_videos(os.path.join(out, split), (f for f in map(frames_of, files) if f))
    print(f"wrote {n} videos to {out}/{split}")


def convert_npy(src: str, out: str, split: str) -> None:
    """An (N, T, H, W[, C]) array (.npy, or the first of an .npz) -> <out>/<split>;
    non-uint8 values are taken as [0, 1] and scaled to uint8."""
    from extdm_tpu_torch.data.synthetic import write_video_hdf5

    arr = np.load(src)
    if hasattr(arr, "files"):
        arr = arr[arr.files[0]]
    if arr.ndim not in (4, 5):
        raise ValueError(f"{src}: an (N, T, H, W[, C]) array, not {arr.shape}")
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    write_video_hdf5(arr, os.path.join(out, split))
    print(f"wrote {arr.shape[0]} videos to {out}/{split}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("shapes", help="synthetic bouncing-sprites dataset")
    sp.add_argument("--out", required=True)
    sp.add_argument("--num_train", type=int, default=256)
    sp.add_argument("--num_valid", type=int, default=64)
    sp.add_argument("--num_frames", type=int, default=30)
    sp.add_argument("--image_size", type=int, default=64)
    sp.add_argument("--seed", type=int, default=0)

    fp = sub.add_parser("frames", help="frame-folder tree -> h5 shards")
    fp.add_argument("--src", required=True)
    fp.add_argument("--out", required=True)
    fp.add_argument("--split", default="train")
    fp.add_argument("--image_size", type=int, default=64)

    np_ = sub.add_parser("npy", help="(N,T,H,W[,C]) array -> h5 shards")
    np_.add_argument("--src", required=True)
    np_.add_argument("--out", required=True)
    np_.add_argument("--split", default="train")

    vp = sub.add_parser("videos", help="directory of video files -> h5 shards (cv2)")
    vp.add_argument("--src", required=True)
    vp.add_argument("--out", required=True)
    vp.add_argument("--split", default="train")
    vp.add_argument("--image_size", type=int, default=64)
    vp.add_argument("--gray", action="store_true", help="store grayscale (KTH-style)")

    mp = sub.add_parser("smmnist", help="stochastic moving MNIST from raw MNIST idx files")
    mp.add_argument("--mnist_images", required=True,
                    help="path to train-images-idx3-ubyte[.gz]")
    mp.add_argument("--out", required=True)
    mp.add_argument("--split", default="train")
    mp.add_argument("--num_videos", type=int, default=8000)
    mp.add_argument("--num_frames", type=int, default=30)
    mp.add_argument("--image_size", type=int, default=64)
    mp.add_argument("--num_digits", type=int, default=2)
    mp.add_argument("--seed", type=int, default=0)

    bp = sub.add_parser("bair", help="BAIR push tfrecords -> h5 shards (no tensorflow)")
    bp.add_argument("--src", required=True, help="directory of .tfrecord files")
    bp.add_argument("--out", required=True)
    bp.add_argument("--split", default="train")

    kp = sub.add_parser("kth", help="raw KTH avis -> person-split h5 stores "
                                    "(train persons 01-20, test 21-25)")
    kp.add_argument("--src", required=True, help="dir of KTH .avi files (flat or per-action)")
    kp.add_argument("--out", required=True)
    kp.add_argument("--image_size", type=int, default=64)

    cp = sub.add_parser("cityscapes", help="leftImg8bit_sequence png tree -> h5 shards")
    cp.add_argument("--src", required=True,
                    help="leftImg8bit_sequence root (contains train/ val/)")
    cp.add_argument("--out", required=True)
    cp.add_argument("--image_size", type=int, default=64)
    cp.add_argument("--splits", default="train:train,val:test",
                    help="comma list of <src_split>:<out_split>")

    up = sub.add_parser("ucf101", help="UCF-101 avis + ucfTrainTestlist -> single h5 store "
                                       "with num_train/num_test metadata")
    up.add_argument("--src", required=True, help="UCF-101 root (class dirs)")
    up.add_argument("--splits_dir", required=True, help="ucfTrainTestlist dir")
    up.add_argument("--out", required=True)
    up.add_argument("--image_size", type=int, default=64)
    up.add_argument("--split_id", type=int, default=1)
    return p


def main(argv=None) -> int:
    from extdm_tpu_torch.data import converters as conv

    args = parser().parse_args(argv)
    if args.cmd == "shapes":
        from extdm_tpu_torch.data.synthetic import write_moving_shapes_dataset

        write_moving_shapes_dataset(args.out, args.num_train, args.num_valid, args.num_frames,
                                    args.image_size, args.seed)
        print(f"synthetic dataset at {args.out}")
    elif args.cmd == "frames":
        convert_frames_tree(args.src, args.out, args.image_size, args.split)
    elif args.cmd == "npy":
        convert_npy(args.src, args.out, args.split)
    elif args.cmd == "videos":
        convert_video_files(args.src, args.out, args.split, args.image_size, args.gray)
    elif args.cmd == "smmnist":
        images = conv.load_mnist_images(args.mnist_images)
        n = write_videos(os.path.join(args.out, args.split),
                         conv.make_smmnist(images, args.num_videos, args.num_frames,
                                           args.image_size, args.num_digits, seed=args.seed))
        print(f"wrote {n} videos to {args.out}/{args.split}")
    elif args.cmd == "kth":
        from extdm_tpu_torch.data.h5 import HDF5VideoWriter

        writers = {s: HDF5VideoWriter(os.path.join(args.out, s), force=True)
                   for s in ("train", "test")}
        counts = {"train": 0, "test": 0}
        for split, _, video in conv.iter_kth_videos(args.src, args.image_size):
            writers[split].add_video(list(video))
            counts[split] += 1
        for w in writers.values():
            w.close()
        print(f"wrote {counts['train']} train / {counts['test']} test videos to {args.out}")
    elif args.cmd == "cityscapes":
        for pair in args.splits.split(","):
            src_split, out_split = pair.split(":")
            n = write_videos(os.path.join(args.out, out_split),
                             conv.iter_cityscapes_videos(args.src, src_split, args.image_size))
            print(f"wrote {n} {src_split} videos to {args.out}/{out_split}")
    elif args.cmd == "ucf101":
        from extdm_tpu_torch.data.h5 import HDF5VideoWriter

        writer = HDF5VideoWriter(args.out, force=True)  # one store, train first
        counts = {"train": 0, "test": 0}
        for split, video in conv.iter_ucf101_videos(args.src, args.splits_dir,
                                                    args.image_size, args.split_id):
            writer.add_video(list(video))
            counts[split] += 1
        writer.set_scalar("num_train", counts["train"])
        writer.set_scalar("num_test", counts["test"])
        writer.close()
        print(f"wrote {counts['train']} train + {counts['test']} test videos to {args.out}")
    elif args.cmd == "bair":
        n = write_videos(os.path.join(args.out, args.split), conv.iter_bair_videos(args.src))
        print(f"wrote {n} videos to {args.out}/{args.split}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
