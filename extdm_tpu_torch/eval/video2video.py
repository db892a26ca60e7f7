"""Motion transfer between videos with the LFAE (port of
scripts/video2video.py).

    python -m extdm_tpu_torch.eval.video2video --config configs/DM/kth.yaml \\
        --flowae_checkpoint RegionMM.pth --motion_indices 1,2,3 [--dump_flow] \\
        [--synthetic_videos 4] [--device cpu]

The appearance video's reference frame (frame tc - 1) is put into each
motion video at tc - 1; one ``encode_video(..., with_decode=True)`` call over
all motion videos then warps it toward every frame of each (the region and
background motion of the motion video, the generator's decode). Writes
``appearance.gif``, ``motion_<i>.gif`` and ``transfer_<i>.gif`` (i the
motion video's dataset index) and, with ``--dump_flow``,
``flow_<i>/flow_tNNN.png`` (the flow's colours) and ``grid_tNNN.png`` (the
warped grid's mesh). Data: ``--root_dir`` (the config's HDF5 shards; needs
h5py) or ``--synthetic_videos N`` (moving-shapes videos made in memory from
``--seed``). Weights: ``--flowae_checkpoint`` as valid_dm reads it, else
the LFAE's seeded random init. Runs on ``--device`` (the card unless
``--device cpu``).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from extdm_tpu_torch.utils.flow_viz import flow2fig, grid2fig
from extdm_tpu_torch.utils.visualize import save_gif, save_image, to_uint8


@torch.no_grad()
def transfer(lfae, hybrid: np.ndarray, cond_frames: int, device) -> Dict[str, np.ndarray]:
    """One ``encode_video(with_decode=True)`` call on `device` over the hybrid
    videos: {"out_vid": (M, T, H, W, 3), "flow": (M, T, h, w, 2)} in host
    memory."""
    out = lfae.encode_video(torch.from_numpy(hybrid).to(device), cond_frames, with_decode=True)
    return {k: out[k].float().cpu().numpy() for k in ("out_vid", "flow")}


def main(argv=None) -> int:
    from extdm_tpu_torch.config import load_config
    from extdm_tpu_torch.data import (InMemoryVideoStore, VideoDataset, make_moving_shapes_video,
                                      to_rgb_video)
    from extdm_tpu_torch.eval.valid_dm import load_lfae
    from extdm_tpu_torch.models.dm.flow_diffusion import LFAE, resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--flowae_checkpoint", default="")
    p.add_argument("--root_dir", default=None)
    p.add_argument("--synthetic_videos", type=int, default=0,
                   help="take the videos from this many moving-shapes videos made in memory")
    p.add_argument("--log_dir", default="logs/video2video")
    p.add_argument("--appearance_index", type=int, default=0,
                   help="dataset index of the video giving the reference frame")
    p.add_argument("--motion_indices", default="1,2,3",
                   help="comma-separated dataset indices of the videos giving the motion")
    p.add_argument("--num_frames", type=int, default=20)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--dump_flow", action="store_true",
                   help="also save each frame's flow colours and warped grid")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    dp = cfg["dataset_params"]
    vp = dp["valid_params"]
    tc, size = vp["cond_frames"], dp["frame_shape"]
    os.makedirs(args.log_dir, exist_ok=True)
    if args.synthetic_videos:
        rng = np.random.RandomState(args.seed)
        data = InMemoryVideoStore([make_moving_shapes_video(rng, args.num_frames, size)
                                   for _ in range(args.synthetic_videos)], name="synthetic")
    else:
        data = args.root_dir or dp["root_dir"]
    dataset = VideoDataset(data, type=vp["type"], num_frames=args.num_frames, image_size=size,
                           random_time=False, seed=args.seed)
    motion_ids = [int(i) for i in args.motion_indices.split(",")]
    appearance = to_rgb_video(dataset[args.appearance_index][0])  # (T, H, W, 3)
    motions = np.stack([to_rgb_video(dataset[i][0]) for i in motion_ids])

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        lfae = LFAE(cfg["flow_params"]["model_params"])
    if args.flowae_checkpoint:
        load_lfae(lfae, args.flowae_checkpoint)
        print(f"loaded LFAE from {args.flowae_checkpoint}")
    else:
        print("WARNING: no --flowae_checkpoint; using random LFAE (smoke mode)")
    lfae = lfae.to(device).eval().requires_grad_(False)

    hybrid = motions.copy()  # the appearance video's reference frame in each motion video
    hybrid[:, tc - 1] = appearance[tc - 1]
    out = transfer(lfae, hybrid, tc, device)
    save_gif(os.path.join(args.log_dir, "appearance.gif"), [to_uint8(f) for f in appearance],
             fps=10)
    for m, mid in enumerate(motion_ids):
        save_gif(os.path.join(args.log_dir, f"motion_{mid}.gif"),
                 [to_uint8(f) for f in motions[m]], fps=10)
        save_gif(os.path.join(args.log_dir, f"transfer_{mid}.gif"),
                 [to_uint8(f) for f in out["out_vid"][m]], fps=10)
        if args.dump_flow:
            fdir = os.path.join(args.log_dir, f"flow_{mid}")
            for t in range(out["flow"].shape[1]):
                save_image(os.path.join(fdir, f"flow_t{t:03d}.png"), flow2fig(out["flow"][m, t]))
                save_image(os.path.join(fdir, f"grid_t{t:03d}.png"),
                           grid2fig(out["flow"][m, t], grid_size=32, img_size=size))
    print(f"motion-transfer gifs -> {args.log_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
