"""Stage-1 evaluation (port of scripts/valid_ae.py).

    python -m extdm_tpu_torch.eval.valid_ae --config configs/AE/kth.yaml \\
        --checkpoint logs/ae_kth/RegionMM.ckpt [--synthetic_videos N] [--device cpu]

The LFAE warps each held-out clip's last cond frame to every frame of the
clip (``train_ae.reconstruct_clips``: ``encode_video(with_decode=True)``);
reported are the reconstruction rate (frames a second over the whole loop,
loader, canonicalisation, encode and host copies, as the reference times
it), FVD, PSNR, SSIM, the L1 out and warp losses (x10, as the reference)
and whether the I3D is pretrained, printed and written to
``<log_dir>/metrics.json``. Weights:
``--checkpoint``, an AE training checkpoint or an LFAE state dict (without
one the LFAE keeps its seeded init); the I3D takes ``--i3d_state_dict`` or
stays seeded random. Data: the config's HDF5 shards or ``--synthetic_videos
N`` moving-shapes videos made in memory from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main(argv=None) -> int:
    from extdm_tpu_torch.config import load_config
    from extdm_tpu_torch.data import InMemoryVideoStore, make_moving_shapes_video
    from extdm_tpu_torch.eval.valid_dm import _sync, load_lfae
    from extdm_tpu_torch.metrics import I3DExtractor
    from extdm_tpu_torch.models.dm.flow_diffusion import LFAE, resolve_device
    from extdm_tpu_torch.train.checkpoint import load_checkpoint
    from extdm_tpu_torch.train.job import video_metrics
    from extdm_tpu_torch.train.train_ae import reconstruct_clips, valid_loader

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--root_dir", default=None)
    p.add_argument("--synthetic_videos", type=int, default=0,
                   help="evaluate on this many moving-shapes videos made in memory")
    p.add_argument("--log_dir", default="logs/ae_valid")
    p.add_argument("--total_videos", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--i3d_state_dict", default="", help="pytorch_i3d weights (.pth)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    dp = cfg["dataset_params"]
    vp = dp["valid_params"]
    tc, tp = vp["cond_frames"], vp["pred_frames"]
    dev = resolve_device(args.device)
    os.makedirs(args.log_dir, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        lfae = LFAE(cfg["flow_params"]["model_params"])
    lfae = lfae.to(dev).eval().requires_grad_(False)
    if args.checkpoint:
        load_lfae(lfae, args.checkpoint)
        print(f"loaded {args.checkpoint}")
    else:
        print("WARNING: no --checkpoint; using random LFAE (smoke mode)")

    total_videos = args.total_videos or vp.get("total_videos", 256)
    if args.synthetic_videos:
        rng = np.random.RandomState(args.seed)
        data = InMemoryVideoStore([make_moving_shapes_video(rng, tc + tp, dp["frame_shape"])
                                   for _ in range(args.synthetic_videos)], name="synthetic")
        total_videos = min(total_videos, args.synthetic_videos)
    else:
        data = args.root_dir or dp["root_dir"]
    loader = valid_loader(cfg, data, total_videos, args.batch_size, args.seed, dev,
                          num_workers=8)

    _sync(dev)
    t0 = time.perf_counter()
    real, recon, warped = reconstruct_clips(lfae, loader, tc)
    fps = real.shape[0] * real.shape[1] / (time.perf_counter() - t0)
    print(f"reconstruction throughput: {fps:.1f} frames/s")

    i3d = I3DExtractor(load_checkpoint(args.i3d_state_dict) if args.i3d_state_dict else None,
                       device=dev)
    vm = video_metrics(recon, real, i3d)
    results = {"fvd": vm["valid_fvd"], "psnr": vm["valid_psnr"], "ssim": vm["valid_ssim"],
               "l1_out_loss": float((real * 10 - recon * 10).abs().mean()),
               "l1_warp_loss": float((real * 10 - warped * 10).abs().mean()),
               "fps": fps, "i3d_pretrained": i3d.pretrained}
    print(json.dumps(results, indent=2))
    with open(os.path.join(args.log_dir, "metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
