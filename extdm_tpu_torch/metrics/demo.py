"""All four video metrics on two sets of videos, as one JSON document (port
of scripts/metrics_demo.py, the reference's metrics/demo.py).

    python -m extdm_tpu_torch.metrics.demo                   # zeros against ones
    python -m extdm_tpu_torch.metrics.demo --videos1 a.npy --videos2 b.npy \\
        [--i3d_params i3d.msgpack | --i3d_state_dict i3d.pth] \\
        [--lpips_params lpips.msgpack | --lpips_state_dict lpips.pth] [--device cpu]

Videos: 8 x 30 frames x 64^2 x 3 of zeros against ones (the reference's
dummy batches), or two .npy files (N, T, H, W, C) in [0, 1]. FVD
(``calculate_fvd1``), PSNR, SSIM and LPIPS run on ``--device`` (the card
unless ``--device cpu``); the document has each metric's mean, std and
per-frame means, and whether each backbone is pretrained. Without weights
the I3D and LPIPS networks are seeded random and a warning on stderr says
their numbers are not comparable with published ones.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch


def demo_metrics(videos1: np.ndarray, videos2: np.ndarray, i3d, lpips, device,
                 batch: int = 8, seconds: Optional[dict] = None) -> dict:
    """The demo's document for (N, T, H, W, C) videos in [0, 1]; each
    metric's seconds (the device synchronised) into `seconds` if given."""
    from extdm_tpu_torch.eval.valid_dm import _sync
    from extdm_tpu_torch.metrics import calculate_fvd1, calculate_psnr1, calculate_ssim1

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        if seconds is not None:
            seconds[name] = time.perf_counter() - t0
        return out

    fvd = timed("fvd", lambda: calculate_fvd1(videos1, videos2, i3d, bs=batch))
    result = {"fvd": float(fvd), "fvd_backbone_pretrained": i3d.pretrained}
    v1, v2 = torch.from_numpy(videos1).to(device), torch.from_numpy(videos2).to(device)
    tchw = lambda v: v.permute(0, 1, 4, 2, 3)  # noqa: E731  (PSNR / SSIM: channels first)
    stats = {"psnr": timed("psnr", lambda: calculate_psnr1(tchw(v1), tchw(v2))),
             "ssim": timed("ssim", lambda: calculate_ssim1(tchw(v1), tchw(v2))),
             "lpips": timed("lpips", lambda: lpips.calculate_lpips1(v1, v2))}
    for name, (mean, std) in stats.items():
        result[name] = float(mean[name])
        result[f"{name}_std"] = float(std[name])
        result[f"{name}_per_frame"] = [float(v) for v in mean[f"{name}_per_frame"]]
    result["lpips_backbone_pretrained"] = lpips.pretrained
    return result


def main(argv=None) -> int:
    from extdm_tpu_torch.eval.valid_dm import add_backbone_flags, load_backbones
    from extdm_tpu_torch.metrics import I3DExtractor, LPIPSMetric
    from extdm_tpu_torch.models.dm.flow_diffusion import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--videos1", default=None, help=".npy (N, T, H, W, C) in [0, 1]")
    ap.add_argument("--videos2", default=None, help=".npy (N, T, H, W, C) in [0, 1]")
    ap.add_argument("--num_videos", type=int, default=8)
    ap.add_argument("--video_length", type=int, default=30)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    add_backbone_flags(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.videos1:
        videos1 = np.load(args.videos1).astype(np.float32)
        videos2 = np.load(args.videos2).astype(np.float32)
    else:
        shape = (args.num_videos, args.video_length, args.size, args.size, 3)
        videos1, videos2 = np.zeros(shape, np.float32), np.ones(shape, np.float32)
    i3d, lpips = load_backbones(device, args.i3d_state_dict, args.i3d_params,
                                args.lpips_state_dict, args.lpips_params)
    i3d = i3d or I3DExtractor(device=device)
    lpips = lpips or LPIPSMetric(device=device)
    result = demo_metrics(videos1, videos2, i3d, lpips, device, args.batch)
    if not i3d.pretrained or not lpips.pretrained:
        print("WARNING: random-init I3D/LPIPS backbones — FVD/LPIPS values are NOT comparable "
              "to published numbers (pass --i3d_params / --lpips_params with converted weights, "
              "or --i3d_state_dict / --lpips_state_dict).", file=sys.stderr)
    print(json.dumps(result, indent=4))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
