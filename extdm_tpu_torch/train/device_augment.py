"""Stage-1 pair augmentation on the device (port of
extdm_tpu/train/device_augment.py).

The loader ships raw uint8 stored-layout pairs; the flip / geometry / colour
jitter chain runs on the card inside the train step, with parameters drawn
per pair. Each step is split in two: ``sample_augment`` draws the per-pair
parameters from a ``torch.Generator``, ``augment_pairs`` applies given
parameters, so a caller (or a test) can supply its own draws.

Semantics are the JAX package's: time_flip swaps source and driving, and
when it fires the horizontal flip is skipped; geometry (rotation -> resize
-> crop) is one composed per-pair coordinate map and one bilinear gather
with zero fill; the colour jitter runs in the fixed order brightness,
saturation, hue (an exact HSV rotation), contrast.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

AugmentParams = Dict[str, Optional[torch.Tensor]]


def canonicalize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W) / (B, H, W, 1|3) stored layout -> float32 (B, H, W, 3)
    in [0, 1]; float input passes through."""
    if not torch.is_floating_point(x):
        x = x.float() / 255.0
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.repeat_interleave(3, dim=-1)
    return x


def _rgb_to_hsv(x: torch.Tensor):
    """(..., 3) in [0, 1] -> (h in [0, 1), s, v)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    s = torch.where(maxc == 0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc), maxc))
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), (h / 6.0) % 1.0)
    return h, s, maxc


def _hsv_to_rgb(h, s, v) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.long() % 6

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _luma(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114


# ---------------------------------------------------------------- geometry
def _bilinear_zero(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); ys/xs (B, h, w) source coords -> (B, h, w, C),
    bilinear with zero fill outside the source rectangle."""
    B, H, W, C = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    flat = img.reshape(B, H * W, C)

    def corner(yi, xi):
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]
        idx = (yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()).reshape(B, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(yi.shape + (C,))
        return torch.where(valid, vals, torch.zeros_like(vals))

    top = corner(y0, x0) * (1 - wx) + corner(y0, x0 + 1) * wx
    bot = corner(y0 + 1, x0) * (1 - wx) + corner(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def sample_geometry(generator: Optional[torch.Generator], B: int, in_hw, out_size: int,
                    resize_param: Optional[dict] = None, rotation_param: Optional[dict] = None,
                    crop_param: Optional[dict] = None, device=None):
    """Per-pair (angle in radians, sy, sx, offy, offx), each (B,): angle
    uniform in the rotation range; one scale uniform in the resize ratio for
    both axes, snapped to floor(dim * s) / dim; crop offsets uniform over the
    covered span, or the centred zero-pad offset when the resized frame is
    smaller than the crop."""
    H, W = in_hw
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        (B,), generator=generator, device=device)
    zeros = torch.zeros((B,), device=device)
    if rotation_param:
        deg = rotation_param.get("degrees", 0.0)
        lo, hi = (-deg, deg) if not isinstance(deg, (tuple, list)) else tuple(deg)
        angle = uniform(lo, hi) * (math.pi / 180.0)
    else:
        angle = zeros
    if resize_param:
        s = uniform(*resize_param.get("ratio", (3.0 / 4.0, 4.0 / 3.0)))
    else:
        s = torch.ones((B,), device=device)
    sy, sx = torch.floor(H * s) / H, torch.floor(W * s) / W

    def offset(scale, dim):
        resized = torch.floor(dim * scale)
        u = torch.rand((B,), generator=generator, device=device) * (resized - out_size).clamp(min=0)
        return torch.where(resized >= out_size, u, -torch.floor((out_size - resized) / 2.0))

    if crop_param or resize_param:
        return angle, sy, sx, offset(sy, H), offset(sx, W)
    return angle, sy, sx, zeros, zeros


def apply_geometry(img: torch.Tensor, out_size: int, angle, sy, sx, offy, offx) -> torch.Tensor:
    """img (B, H, W, C) float -> (B, out, out, C): per pair, rotation about the
    centre (cv2 convention), resize by (sy, sx), crop at (offy, offx), as one
    coordinate map and one bilinear gather."""
    B, H, W = img.shape[:3]
    r = torch.arange(out_size, dtype=torch.float32, device=img.device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    col = lambda v: v.reshape(B, 1, 1)  # noqa: E731
    ry = (gy + col(offy) + 0.5) / col(sy) - 0.5
    rx = (gx + col(offx) + 0.5) / col(sx) - 0.5
    cy, cx = H / 2.0, W / 2.0
    dy, dx = ry - cy, rx - cx
    c, sn = col(torch.cos(angle)), col(torch.sin(angle))
    return _bilinear_zero(img, sn * dx + c * dy + cy, c * dx - sn * dy + cx)


# ------------------------------------------------------------------- pairs
def sample_augment(generator: Optional[torch.Generator], B: int, in_hw, device=None,
                   flip_param: Optional[dict] = None, jitter_param: Optional[dict] = None,
                   resize_param: Optional[dict] = None, rotation_param: Optional[dict] = None,
                   crop_param: Optional[dict] = None) -> AugmentParams:
    """Draw the per-pair parameters of ``augment_pairs``: "time" and "hflip"
    (B,) bool masks (None when that flip is off), "brightness",
    "saturation", "contrast" (B, 1, 1, 1) and "hue" (B, 1, 1) factors (None
    when off), and "geometry" (out_size, angle, sy, sx, offy, offx) or None."""
    fp, jp = flip_param or {}, jitter_param or {}
    coin = lambda: torch.rand((B,), generator=generator, device=device) < 0.5  # noqa: E731
    params: AugmentParams = {"time": coin() if fp.get("time_flip") else None}
    hcoin = coin()
    if params["time"] is not None:
        hcoin = hcoin & ~params["time"]
    params["hflip"] = hcoin if fp.get("horizontal_flip") else None
    params["geometry"] = None
    if resize_param or rotation_param or crop_param:
        size = _crop_size(crop_param, in_hw)
        params["geometry"] = (size, *sample_geometry(generator, B, in_hw, size, resize_param,
                                                     rotation_param, crop_param, device))

    def factor(name, shape):
        a = jp.get(name, 0.0)
        if not a:
            return None
        lo = -a if name == "hue" else max(0.0, 1.0 - a)
        hi = a if name == "hue" else 1.0 + a
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)

    for name in ("brightness", "saturation", "contrast"):
        params[name] = factor(name, (B, 1, 1, 1))
    params["hue"] = factor("hue", (B, 1, 1))
    return params


def augment_rows(params: Optional[AugmentParams], rows: slice) -> Optional[AugmentParams]:
    """The pairs `rows` of drawn parameters: a data-parallel rank's share
    of draws made for the global batch (a rank of the data-parallel step
    otherwise draws its own, from its rank's generator)."""
    if params is None:
        return None
    out = {k: None if v is None else v[rows] for k, v in params.items() if k != "geometry"}
    geo = params["geometry"]
    out["geometry"] = None if geo is None else (geo[0], *(g[rows] for g in geo[1:]))
    return out


def _crop_size(crop_param: Optional[dict], in_hw) -> int:
    cs = (crop_param or {}).get("size", in_hw[0])
    if isinstance(cs, (tuple, list)):
        if cs[0] != cs[1]:
            raise ValueError(f"device geometry supports square crops, got {cs}")
        cs = cs[0]
    return int(cs)


def _jitter(img: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    if p["brightness"] is not None:
        img = (img * p["brightness"]).clamp(0.0, 1.0)
    if p["saturation"] is not None:
        sf = p["saturation"]
        img = (_luma(img)[..., None] * (1.0 - sf) + img * sf).clamp(0.0, 1.0)
    if p["hue"] is not None:
        h, s, v = _rgb_to_hsv(img)
        img = _hsv_to_rgb((h + p["hue"]) % 1.0, s, v).clamp(0.0, 1.0)
    if p["contrast"] is not None:
        cf = p["contrast"]
        mean = _luma(img).mean(dim=(-2, -1), keepdim=True)[..., None]
        img = (mean * (1.0 - cf) + img * cf).clamp(0.0, 1.0)
    return img


def augment_pairs(source: torch.Tensor, driving: torch.Tensor,
                  params: AugmentParams) -> tuple:
    """Apply drawn parameters to a uint8 stored-layout or float (B, H, W, 3)
    pair; returns the augmented float32 RGB pair. Host op order: flip ->
    geometry -> jitter, the geometry shared across the pair."""
    src, drv = canonicalize_images(source), canonicalize_images(driving)
    if params["time"] is not None:
        m = params["time"][:, None, None, None]
        src, drv = torch.where(m, drv, src), torch.where(m, src, drv)
    if params["hflip"] is not None:
        m = params["hflip"][:, None, None, None]
        src, drv = torch.where(m, src.flip(2), src), torch.where(m, drv.flip(2), drv)
    if params["geometry"] is not None:
        out_size, *geo = params["geometry"]
        src, drv = apply_geometry(src, out_size, *geo), apply_geometry(drv, out_size, *geo)
    return _jitter(src, params), _jitter(drv, params)


def prepare_batch(source: torch.Tensor, driving: torch.Tensor,
                  params: Optional[AugmentParams]) -> tuple:
    """Canonicalize a (source, driving) batch and, given drawn parameters,
    augment it."""
    if params is None:
        return canonicalize_images(source), canonicalize_images(driving)
    return augment_pairs(source, driving, params)
