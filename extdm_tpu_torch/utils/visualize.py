"""Pictures of the training jobs (port of the parts of
extdm_tpu/utils/visualize.py they call): the DM img/vid shot panels, the AE
region grid, and PNG and GIF writers.

The card's machine has no imageio, cv2 or matplotlib, so ``save_image``
writes PNG with zlib and struct, ``save_gif`` writes a GIF89a with a fixed
3-3-2 palette and its own LZW coder, ``RegionVisualizer`` resizes with
``F.interpolate`` (``data/augmentation.resize``) and carries matplotlib's
gist_rainbow as its own table.
Videos are (T, H, W, C) float in [0, 1]; images (H, W, 3).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Sequence

import numpy as np

from extdm_tpu_torch.data.augmentation import resize
from extdm_tpu_torch.utils.flow_viz import conf2fig, grid2fig

COND_COLOR = (0, 114, 189)  # blue
PRED_COLOR = (217, 83, 25)  # orange


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def add_border(frame: np.ndarray, color, width: int = 2) -> np.ndarray:
    """frame: (H, W, 3) uint8."""
    out = frame.copy()
    c = np.asarray(color, np.uint8)
    out[:width], out[-width:] = c, c
    out[:, :width], out[:, -width:] = c, c
    return out


# ------------------------------------------------------------------ writers
def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_image(path: str, img: np.ndarray) -> None:
    """(H, W), (H, W, 1) or (H, W, 3) image, uint8 or float in [0, 1] -> an
    8-bit PNG (gray or RGB)."""
    img = img if img.dtype == np.uint8 else to_uint8(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    data = (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


# The GIF palette: 8 levels of red and green, 4 of blue (index rrrgggbb).
_LEVELS = (8, 8, 4)
GIF_PALETTE = np.stack(np.meshgrid(*[np.round(np.arange(n) * 255.0 / (n - 1)) for n in _LEVELS],
                                   indexing="ij"), -1).reshape(256, 3).astype(np.uint8)


def gif_indices(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) indices of the nearest GIF_PALETTE level per channel."""
    f = frame.astype(np.int32)
    r, g, b = ((f[..., c] * (n - 1) + 127) // 255 for c, n in enumerate(_LEVELS))
    return (r * 32 + g * 4 + b).astype(np.uint8)


def _lzw(indices: np.ndarray, min_size: int = 8) -> bytes:
    """GIF LZW of 8-bit indices: codes from 9 to 12 bits, packed LSB first, a
    clear code whenever the table is full."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    size, nxt, table = min_size + 1, eoi + 1, {}
    emit(clear, size)
    data = indices.tobytes()
    w = data[0]
    for k in data[1:]:
        key = (w, k)
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, size)
        table[key] = nxt
        nxt += 1
        if nxt > (1 << size) and size < 12:
            size += 1
        if nxt == 4096:
            emit(clear, size)
            size, nxt, table = min_size + 1, eoi + 1, {}
        w = k
    emit(w, size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def save_gif(path: str, frames: Sequence[np.ndarray], fps: int = 10) -> None:
    """(H, W, 3) uint8 frames -> a looping GIF89a in GIF_PALETTE's colours."""
    frames = [f if f.dtype == np.uint8 else to_uint8(f) for f in frames]
    h, w = frames[0].shape[:2]
    delay = int(round(100.0 / fps))
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), GIF_PALETTE.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
    for frame in frames:
        data = _lzw(gif_indices(frame))
        blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                          for i in range(0, len(data), 255))
        parts += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                  b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08", blocks, b"\x00"]
    parts.append(b"\x3b")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(parts))


# ---------------------------------------------------------------- DM shots
def _nearest_upscale(img: np.ndarray, size: int) -> np.ndarray:
    """Integer nearest-neighbour upscale of (h, w[, c]) to (size, size[, c])."""
    r = max(1, size // img.shape[0])
    return np.repeat(np.repeat(img, r, axis=0), r, axis=1)[:size, :size]


def dm_shot_panel(ret: dict, target_frame: np.ndarray, nf: int, tc: int) -> np.ndarray:
    """One 2 x 5 DM training shot frame (ref scripts/DM/train.py:316-345):

        | src | real_out | real_warp | real_grid | real_conf |
        | tar | fake_out | fake_warp | fake_grid | fake_conf |

    `ret` is ``FlowDiffusion.make_monitor``'s output as numpy (batch element
    0 is drawn), `target_frame` the real frame at index nf in [tc, tc+tp).
    Returns (2 msk, 5 msk, 3) uint8."""
    msk = target_frame.shape[0]
    nfp = nf - tc  # index into the predicted frames

    def px(img):
        return to_uint8(np.asarray(img, np.float32))

    def conf_img(conf):
        if conf is None:
            return np.full((msk, msk, 3), 255, np.uint8)
        return np.stack([_nearest_upscale(conf2fig(np.asarray(conf, np.float32)), msk)] * 3, -1)

    def grid_img(grid):
        return grid2fig(np.asarray(grid, np.float32), grid_size=12, img_size=msk)

    def conf_of(key, i):
        return None if ret.get(key) is None else ret[key][0, i]

    top = [px(ret["ref_imgs"][0]), px(ret["real_out_vid"][0, nf]),
           px(ret["real_warped_vid"][0, nf]), grid_img(ret["real_vid_grid"][0, nf]),
           conf_img(conf_of("real_vid_conf", nf))]
    bot = [px(target_frame), px(ret["fake_out_vid"][0, nfp]), px(ret["fake_warped_vid"][0, nfp]),
           grid_img(ret["fake_vid_grid"][0, nfp]), conf_img(conf_of("fake_vid_conf", nfp))]
    return np.concatenate([np.concatenate(top, axis=1), np.concatenate(bot, axis=1)], axis=0)


def dm_imgshot(ret: dict, video: np.ndarray, tc: int, tp: int) -> np.ndarray:
    """The reference imgshot: one panel at the middle predicted frame."""
    nf = tc + tp // 2
    return dm_shot_panel(ret, np.asarray(video[0, nf], np.float32), nf, tc)


def dm_vidshot(ret: dict, video: np.ndarray, tc: int, tp: int) -> List[np.ndarray]:
    """The reference vidshot: one panel per predicted frame (the GIF's frames)."""
    return [dm_shot_panel(ret, np.asarray(video[0, nf], np.float32), nf, tc)
            for nf in range(tc, tc + tp)]


# ---------------------------------------------------------- AE region grid
# matplotlib's gist_rainbow (its _gist_rainbow_data): (position, (r, g, b)).
GIST_RAINBOW = ((0.000, (1.00, 0.00, 0.16)), (0.030, (1.00, 0.00, 0.00)),
                (0.215, (1.00, 1.00, 0.00)), (0.400, (0.00, 1.00, 0.00)),
                (0.586, (0.00, 1.00, 1.00)), (0.770, (0.00, 0.00, 1.00)),
                (0.954, (1.00, 0.00, 1.00)), (1.000, (1.00, 0.00, 0.75)))


def _colormap_table(segments, n: int = 256) -> np.ndarray:
    """(n, 3) table of a piecewise-linear colormap at i / (n - 1), as
    matplotlib's LinearSegmentedColormap(N=256) builds its lookup table."""
    pos = np.asarray([p for p, _ in segments])
    rgb = np.asarray([c for _, c in segments])
    x = np.linspace(0.0, 1.0, n)
    return np.stack([np.interp(x, pos, rgb[:, c]) for c in range(3)], -1)


_GIST_RAINBOW_TABLE = _colormap_table(GIST_RAINBOW)


def gist_rainbow(x: float) -> np.ndarray:
    """The colour of x in [0, 1], picked as matplotlib's colormap call picks it."""
    n = len(_GIST_RAINBOW_TABLE)
    return _GIST_RAINBOW_TABLE[min(max(int(x * n), 0), n - 1)].astype(np.float32)


def _disk_mask(h: int, w: int, cy: float, cx: float, radius: float):
    ys, xs = np.ogrid[:h, :w]
    return (ys - cy) ** 2 + (xs - cx) ** 2 <= radius ** 2


class RegionVisualizer:
    """The AE region diagnostics grid (reference util.py Visualizer): source
    and driving frames with the region centres, the coloured heatmaps, the
    deformed image, the prediction and the occlusion map."""

    def __init__(self, kp_size: int = 5, region_bg_color=(0, 0, 0)):
        self.kp_size = kp_size
        self.region_bg_color = np.asarray(region_bg_color, np.float32)

    def _color(self, i: int, n: int) -> np.ndarray:
        return gist_rainbow(i / max(n, 1))

    def draw_image_with_kp(self, image: np.ndarray, kp: np.ndarray) -> np.ndarray:
        """image (H, W, 3) float in [0, 1]; kp (K, 2) in [-1, 1] (x, y)."""
        img = image.copy()
        h, w = img.shape[:2]
        pix = (kp + 1) / 2 * np.asarray([w, h])
        for i, (x, y) in enumerate(pix):
            img[_disk_mask(h, w, y, x, self.kp_size)] = self._color(i, len(pix))
        return img

    def colored_heatmap(self, heatmap: np.ndarray) -> np.ndarray:
        """heatmap (H, W, K) -> (H, W, 3) coloured composite."""
        parts, weights = [], []
        for i in range(heatmap.shape[-1]):
            part = heatmap[..., i:i + 1]
            part = part / max(part.max(), 1e-8)
            weights.append(part)
            parts.append(part * self._color(i, heatmap.shape[-1]))
        weight = np.sum(weights, axis=0)
        bg_w = 1 - np.minimum(1, weight)
        weight = np.maximum(1, weight)
        return (np.sum(parts, axis=0) / weight + bg_w * self.region_bg_color).clip(0, 1)

    def visualize(self, source: np.ndarray, driving: np.ndarray, out: dict,
                  index: int = 0) -> np.ndarray:
        """The grid for one sample (uint8); inputs are channels-last numpy
        arrays as the LFAE forward gives them."""
        h, w = source.shape[1:3]
        src_params, drv_params = out["source_region_params"], out["driving_region_params"]
        cells = [self.draw_image_with_kp(source[index], np.asarray(src_params["shift"][index]))]
        if "heatmap" in src_params:
            cells.append(self.colored_heatmap(
                resize(np.asarray(src_params["heatmap"][index]), (w, h))))
        if "deformed" in out:
            cells.append(np.asarray(out["deformed"][index]))
        cells.append(self.draw_image_with_kp(driving[index], np.asarray(drv_params["shift"][index])))
        cells.append(np.asarray(out["prediction"][index]))
        if "occlusion_map" in out:
            occ = resize(np.asarray(out["occlusion_map"][index]), (w, h))
            if occ.ndim == 2:
                occ = occ[..., None]
            cells.append(np.repeat(occ, 3, axis=-1))
        n = len(cells)
        cols = (n + 1) // 2
        cells = cells + [np.zeros_like(cells[0])] * (2 * cols - n)
        rows = [np.concatenate(cells[:cols], axis=1), np.concatenate(cells[cols:], axis=1)]
        return to_uint8(np.concatenate(rows, axis=0))
