"""Clip augmentations on the host, numpy only (port of
extdm_tpu/data/augmentation.py, which calls cv2: the card's machine has no
cv2).

RandomFlip (time and horizontal), RandomResize, RandomCrop, RandomRotation
and ColorJitter with torchvision's adjust_* semantics (random factors and
random op order), composed by AllAugmentationTransform. Every op takes a
list (or array) of (H, W, C) float32 frames in [0, 1] and applies the same
drawn parameters to every frame. The parameters are drawn from Python's
``random`` (and, in ``batch_call``, numpy's global stream) in the JAX
package's order, so one seed gives the same clips.

cv2's parts: ``resize`` (INTER_NEAREST's floor(x * src / dst); INTER_LINEAR
by ``F.interpolate``),
``warp_affine`` (``getRotationMatrix2D`` + ``warpAffine`` with bilinear taps
and a zero border) and the float RGB <-> HSV conversions of ``cvtColor``
(with its FLT_EPSILON terms).
"""
from __future__ import annotations

import math
import random
from typing import Sequence

import numpy as np
import torch

from extdm_tpu_torch.ops.resize import interpolate_bilinear

Clip = Sequence[np.ndarray]
_FLT_EPSILON = np.float32(1.1920929e-07)


# ------------------------------------------------------------ cv2's pieces
def resize(img: np.ndarray, size, interpolation: str = "linear") -> np.ndarray:
    """(H, W[, C]) -> (new_h, new_w[, C]); size is (new_w, new_h) as cv2 takes
    it. "nearest": pixel floor(x * src / dst); "linear": bilinear on
    half-pixel centres, the taps clamped at the edges (F.interpolate's
    align_corners=False, which is cv2's INTER_LINEAR sampling)."""
    new_w, new_h = size
    h, w = img.shape[:2]
    if interpolation == "nearest":
        ys = np.minimum(np.floor(np.arange(new_h) * (h / new_h)).astype(np.int64), h - 1)
        xs = np.minimum(np.floor(np.arange(new_w) * (w / new_w)).astype(np.int64), w - 1)
        return img[ys][:, xs]
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    out = interpolate_bilinear(x[..., None] if img.ndim == 2 else x, (new_h, new_w)).numpy()
    return (out[..., 0] if img.ndim == 2 else out).astype(img.dtype)


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3), angle in degrees, counter-clockwise."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def warp_affine(img: np.ndarray, mat: np.ndarray, size) -> np.ndarray:
    """cv2.warpAffine(img, mat, size): dst(x, y) = src(mat^-1 (x, y)),
    bilinear, taps outside the image read 0; size is (w, h)."""
    w, h = size
    m = np.asarray(mat, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    ys, xs = np.mgrid[:h, :w].astype(np.float64)
    sx, sy = a11 * xs + a12 * ys + b1, a21 * xs + a22 * ys + b2
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    src = img.astype(np.float32)
    H, W = src.shape[:2]
    extra = (None,) * (src.ndim - 2)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = src[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        return np.where(ok[(...,) + extra], v, np.float32(0))

    fx, fy = fx[(...,) + extra], fy[(...,) + extra]
    out = ((tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy)
           + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy)
    return out.astype(img.dtype)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cvtColor(COLOR_RGB2HSV) for float32: H in [0, 360), S and V in [0, 1]."""
    x = img.astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = np.float32(60.0) / (diff + _FLT_EPSILON)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120.0), (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], -1).astype(np.float32)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cvtColor(COLOR_HSV2RGB) for float32 (H in degrees)."""
    h, s, v = (hsv[..., i].astype(np.float32) for i in range(3))
    h = h * np.float32(6.0 / 360.0)
    h = np.mod(h, np.float32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, np.float32(0), h)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], -1)
    pick = _SECTORS[sector]  # (..., 3): b, g, r
    bgr = np.take_along_axis(tab, pick, axis=-1)
    rgb = bgr[..., ::-1]
    gray = (s == 0)[..., None]
    return np.where(gray, v[..., None], rgb).astype(np.float32)


# --------------------------------------------------------------------- ops
class RandomFlip:
    def __init__(self, time_flip: bool = False, horizontal_flip: bool = False):
        self.time_flip = time_flip
        self.horizontal_flip = horizontal_flip

    def __call__(self, clip: Clip) -> Clip:
        if random.random() < 0.5 and self.time_flip:
            return list(clip)[::-1]
        if random.random() < 0.5 and self.horizontal_flip:
            return [np.fliplr(img) for img in clip]
        return clip


class RandomResize:
    def __init__(self, ratio=(3.0 / 4.0, 4.0 / 3.0), interpolation: str = "nearest"):
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, clip: Clip) -> Clip:
        scale = random.uniform(*self.ratio)
        h, w = clip[0].shape[:2]
        size = (int(w * scale), int(h * scale))
        interp = "nearest" if self.interpolation == "nearest" else "linear"
        return [resize(img, size, interp) for img in clip]


class RandomCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip: Clip) -> Clip:
        h, w = self.size
        im_h, im_w = clip[0].shape[:2]
        pad_h, pad_w = max(0, h - im_h), max(0, w - im_w)
        if pad_h or pad_w:
            clip = [np.pad(img, ((pad_h // 2, pad_h - pad_h // 2),
                                 (pad_w // 2, pad_w - pad_w // 2)) + ((0, 0),) * (img.ndim - 2))
                    for img in clip]
            im_h, im_w = clip[0].shape[:2]
        y1 = 0 if h == im_h else random.randint(0, im_h - h)
        x1 = 0 if w == im_w else random.randint(0, im_w - w)
        return [img[y1:y1 + h, x1:x1 + w] for img in clip]


class RandomRotation:
    def __init__(self, degrees):
        self.degrees = (-degrees, degrees) if isinstance(degrees, (int, float)) else tuple(degrees)

    def __call__(self, clip: Clip) -> Clip:
        angle = random.uniform(*self.degrees)
        h, w = clip[0].shape[:2]
        mat = rotation_matrix((w / 2, h / 2), angle, 1.0)
        return [warp_affine(img, mat, (w, h)) for img in clip]


def _luma(img: np.ndarray) -> np.ndarray:
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def adjust_brightness(img: np.ndarray, factor) -> np.ndarray:
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img: np.ndarray, factor) -> np.ndarray:
    """Per-image luma mean: on a stacked (T, H, W, C) clip, per frame."""
    mean = _luma(img).mean(axis=(-2, -1), keepdims=True)[..., None]
    return np.clip(mean * (1 - factor) + img * factor, 0.0, 1.0)


def adjust_saturation(img: np.ndarray, factor) -> np.ndarray:
    return np.clip(_luma(img)[..., None] * (1 - factor) + img * factor, 0.0, 1.0)


def adjust_hue(img: np.ndarray, hue) -> np.ndarray:
    """hue in [-0.5, 0.5], a fraction of a turn (torchvision); a scalar or an
    array that broadcasts against the hue channel (one value per clip)."""
    hsv = rgb_to_hsv(img)
    hsv[..., 0] = np.mod(hsv[..., 0] + np.asarray(hue, np.float32) * np.float32(360.0),
                         np.float32(360.0))
    return np.clip(hsv_to_rgb(hsv), 0.0, 1.0)


class ColorJitter:
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def sample_params(self):
        def factor(a):
            return random.uniform(max(0, 1 - a), 1 + a) if a else None

        b, c, s = factor(self.brightness), factor(self.contrast), factor(self.saturation)
        h = random.uniform(-self.hue, self.hue) if self.hue else None
        return b, c, s, h

    def __call__(self, clip: Clip) -> Clip:
        b, c, s, h = self.sample_params()
        ops = []
        if b is not None:
            ops.append(lambda img: adjust_brightness(img, b))
        if s is not None:
            ops.append(lambda img: adjust_saturation(img, s))
        if h is not None:
            ops.append(lambda img: adjust_hue(img, h))
        if c is not None:
            ops.append(lambda img: adjust_contrast(img, c))
        random.shuffle(ops)
        stacked = np.stack(clip).astype(np.float32)  # every op is per frame
        for op in ops:
            stacked = op(stacked)
        return list(stacked.astype(np.float32))


class AllAugmentationTransform:
    """The config's augmentation_params sections, composed in the
    reference's order: flip, rotation, resize, crop, jitter."""

    def __init__(self, resize_param=None, rotation_param=None, flip_param=None,
                 crop_param=None, jitter_param=None):
        self.flip_param = flip_param
        self.jitter_param = jitter_param
        self.transforms = []
        if flip_param is not None:
            self.transforms.append(RandomFlip(**flip_param))
        if rotation_param is not None:
            self.transforms.append(RandomRotation(**rotation_param))
        if resize_param is not None:
            self.transforms.append(RandomResize(**resize_param))
        if crop_param is not None:
            self.transforms.append(RandomCrop(**crop_param))
        if jitter_param is not None:
            self.transforms.append(ColorJitter(**jitter_param))
        # flip + jitter only (the KTH, SMMNIST and BAIR AE configs) keeps the
        # frames' geometry: whole batches then take one pass per op
        self.batchable = resize_param is None and rotation_param is None and crop_param is None

    def __call__(self, clip: Clip) -> Clip:
        for t in self.transforms:
            clip = t(clip)
        return clip

    def batch_call(self, clips: np.ndarray) -> np.ndarray:
        """``__call__`` over B clips (B, T, H, W, C) float32 with independent
        per-clip parameters (numpy's global stream) and one op order for the
        batch (``random``), as the JAX package's batch_call draws them."""
        if not self.batchable:
            raise ValueError("batch_call needs a flip + jitter pipeline")
        B = clips.shape[0]
        out = clips
        fp = self.flip_param or {}
        if fp.get("time_flip"):
            tmask = np.random.rand(B) < 0.5
            out = out.copy()
            out[tmask] = out[tmask, ::-1]
            hmask = np.logical_and(~tmask, np.random.rand(B) < 0.5)
        else:
            hmask = np.random.rand(B) < 0.5
        if fp.get("horizontal_flip"):
            out = out.copy() if out is clips else out
            out[hmask] = out[hmask, :, :, ::-1]
        jp = self.jitter_param
        if jp:
            def col(k):
                a = jp.get(k)
                return np.random.uniform(max(0.0, 1 - a), 1 + a, (B, 1, 1, 1, 1)).astype(
                    np.float32) if a else None

            b, c, s = col("brightness"), col("contrast"), col("saturation")
            h = (np.random.uniform(-jp["hue"], jp["hue"], B).astype(np.float32)
                 if jp.get("hue") else None)
            ops = []
            if b is not None:
                ops.append(lambda a: adjust_brightness(a, b))
            if s is not None:
                ops.append(lambda a: adjust_saturation(a, s))
            if h is not None:
                ops.append(lambda a: adjust_hue(a, h[:, None, None, None]))
            if c is not None:
                ops.append(lambda a: adjust_contrast(a, c))
            random.shuffle(ops)
            for op in ops:
                out = op(out)
        return out.astype(np.float32)
