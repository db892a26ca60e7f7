"""Analysis of valid_dm's ``--dump_arrays`` files (port of
scripts/analyze_dumps.py).

    python -m extdm_tpu_torch.eval.analyze_dumps --dump_dir logs/dm_valid \\
        --cond_frames 10 [--per_video] [--render] [--i3d_params i3d.msgpack] [--device cpu]

Reads ``origin`` and ``result`` ((N, T, H, W, 3) in [0, 1]) and, where
present, ``origin_flows`` / ``result_flows`` ((N, T', h, w, 2) backward-warp
grids), each ``.npy`` or the first array of an ``.npz``. Writes to
``--out_dir`` (default ``<dump_dir>/analysis``):
- ``metrics.json``: ``--metrics`` of psnr, ssim, lpips (mean and std over
  videos of the predicted frames) and fvd (whole videos, the cond frames
  included, as the reference computes it), computed on ``--device`` (the
  card unless ``--device cpu``) as the port's metrics compute them;
- ``--per_video``: ``metrics_per_video.csv``, each video's PSNR;
- ``--render``: the origin / result / flow / diff gif grids of the first
  ``--max_render`` videos (``visualize_ori_pre_flow_diff``): the flows as
  colour pictures upscaled to the frame by ``np.kron``, prediction-only
  flows padded white over the cond frames, zeros without flows.
LPIPS and I3D take a reference ``.pth`` or the JAX package's converted
msgpack weights, else stay seeded random (``pretrained: false``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from extdm_tpu_torch.eval.valid_dm import add_backbone_flags, load_backbones
from extdm_tpu_torch.metrics import (I3DExtractor, LPIPSMetric, calculate_fvd2, calculate_psnr1,
                                     calculate_psnr3, calculate_ssim1)
from extdm_tpu_torch.models.dm.flow_diffusion import resolve_device
from extdm_tpu_torch.utils.flow_viz import flow2fig
from extdm_tpu_torch.utils.visualize import visualize_ori_pre_flow_diff


def load_dump(dump_dir: str, name: str) -> Optional[np.ndarray]:
    """<dump_dir>/<name>.npy, or the first array of <name>.npz, as float32;
    None where neither exists."""
    for ext in (".npy", ".npz"):
        path = os.path.join(dump_dir, name + ext)
        if os.path.exists(path):
            arr = np.load(path)
            if ext == ".npz":
                arr = arr[list(arr.keys())[0]]
            return np.asarray(arr, np.float32)
    return None


def flow_frames(grids: np.ndarray, H: int, W: int) -> np.ndarray:
    """(N, T, h, w, 2) warp grids -> (N, T, H, W, 3) colour frames in [0, 1]."""
    N, T = grids.shape[:2]
    out = np.zeros((N, T, H, W, 3), np.float32)
    for i in range(N):
        for t in range(T):
            img = flow2fig(grids[i, t]).astype(np.float32) / 255.0
            ry, rx = H // img.shape[0], W // img.shape[1]
            out[i, t] = np.kron(img, np.ones((ry, rx, 1), np.float32)) if ry > 1 else img[:H, :W]
    return out


def compute_metrics(origin: np.ndarray, result: np.ndarray, tc: int, wanted, device,
                    i3d: Optional[I3DExtractor] = None,
                    lpips: Optional[LPIPSMetric] = None) -> dict:
    """metrics.json's document: PSNR / SSIM / LPIPS of the predicted frames,
    FVD of the whole videos, on `device`."""
    o, r = torch.from_numpy(origin).to(device), torch.from_numpy(result).to(device)
    o_pred, r_pred = o[:, tc:].permute(0, 1, 4, 2, 3), r[:, tc:].permute(0, 1, 4, 2, 3)
    metrics = {}
    if "psnr" in wanted:
        m, s = calculate_psnr1(o_pred, r_pred)
        metrics["psnr"] = {"mean": float(m["psnr"]), "std": float(s["psnr"])}
    if "ssim" in wanted:
        m, s = calculate_ssim1(o_pred, r_pred)
        metrics["ssim"] = {"mean": float(m["ssim"]), "std": float(s["ssim"])}
    if "lpips" in wanted:
        lpips = lpips or LPIPSMetric(device=device)
        m, s = lpips.calculate_lpips1(o[:, tc:], r[:, tc:])
        metrics["lpips"] = {"mean": float(m["lpips"]), "std": float(s["lpips"]),
                            "pretrained": lpips.pretrained}
    if "fvd" in wanted:
        i3d = i3d or I3DExtractor(device=device)
        metrics["fvd"] = {"value": calculate_fvd2(i3d.get_feats(result), i3d.get_feats(origin)),
                          "pretrained": i3d.pretrained}
    return metrics


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dump_dir", required=True)
    p.add_argument("--cond_frames", type=int, default=10)
    p.add_argument("--out_dir", default=None, help="default: <dump_dir>/analysis")
    p.add_argument("--metrics", default="psnr,ssim,lpips,fvd")
    p.add_argument("--per_video", action="store_true", help="write metrics_per_video.csv")
    p.add_argument("--render", action="store_true",
                   help="render the origin / result / flow / diff gif grids")
    p.add_argument("--max_render", type=int, default=16)
    add_backbone_flags(p)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    out_dir = args.out_dir or os.path.join(args.dump_dir, "analysis")
    os.makedirs(out_dir, exist_ok=True)
    origin, result = load_dump(args.dump_dir, "origin"), load_dump(args.dump_dir, "result")
    if origin is None or result is None:
        print(f"origin/result dumps not found in {args.dump_dir} (run valid_dm --dump_arrays "
              "first)", file=sys.stderr)
        return 1
    oflow, rflow = load_dump(args.dump_dir, "origin_flows"), load_dump(args.dump_dir,
                                                                        "result_flows")
    tc, N = args.cond_frames, origin.shape[0]
    print(f"loaded {N} videos, T={origin.shape[1]} (cond {tc})")

    i3d, lpips = load_backbones(device, args.i3d_state_dict, args.i3d_params,
                                args.lpips_state_dict, args.lpips_params)
    metrics = compute_metrics(origin, result, tc, set(args.metrics.split(",")), device, i3d,
                              lpips)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))

    if args.per_video:
        mat = calculate_psnr3(torch.from_numpy(origin[:, tc:]).to(device),
                              torch.from_numpy(result[:, tc:]).to(device))
        with open(os.path.join(out_dir, "metrics_per_video.csv"), "w") as f:
            f.write("id,psnr\n")
            for i, v in enumerate(mat.mean(axis=1)):
                f.write(f"{i},{v:.4f}\n")
        print(f"per-video CSV -> {out_dir}/metrics_per_video.csv")

    if args.render:
        n = min(N, args.max_render)
        H, W = origin.shape[2:4]
        if oflow is not None and rflow is not None:
            of, rf = flow_frames(oflow[:n], H, W), flow_frames(rflow[:n], H, W)
            if of.shape[1] < origin.shape[1]:  # prediction-only flows: white cond frames
                pad = np.ones((n, origin.shape[1] - of.shape[1], H, W, 3), np.float32)
                of, rf = np.concatenate([pad, of], axis=1), np.concatenate([pad, rf], axis=1)
        else:
            of, rf = np.zeros_like(origin[:n]), np.zeros_like(result[:n])
        paths = visualize_ori_pre_flow_diff(out_dir, origin[:n], result[:n], of, rf,
                                            cond_frame_num=tc)
        print(f"rendered {len(paths)} gif grids -> {os.path.dirname(paths[0])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
