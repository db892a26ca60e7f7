"""Flow, confidence and warped-grid pictures (port of
extdm_tpu/utils/flow_viz.py), numpy on the host: the Middlebury colour
wheel of a flow, a warp grid's displacement and its colour picture, a
confidence map in gray, and a warped grid's line mesh."""
from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    """(55, 3) Middlebury colour wheel (Baker et al., ICCV 2007)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_color(flow: np.ndarray, clip: float | None = None) -> np.ndarray:
    """(H, W, 2) flow (u, v) -> (H, W, 3) uint8 colour image."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    if clip is not None:
        u, v = np.clip(u, -clip, clip), np.clip(v, -clip, clip)
    rad_max = max(np.sqrt(u ** 2 + v ** 2).max(), 1e-8)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    n = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (n - 1)
    k0 = np.floor(fk).astype(int) % n
    k1 = (k0 + 1) % n
    f = fk - np.floor(fk)
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0, col1 = _WHEEL[k0, c] / 255.0, _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # white toward zero motion
        img[..., c] = np.floor(255 * col)
    return img


def grid_to_flow(grid: np.ndarray) -> np.ndarray:
    """Backward-warp grid (H, W, 2) in [-1, 1] -> displacement (u, v) in pixels
    from the identity grid."""
    h, w = grid.shape[:2]
    ident_x, ident_y = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    u = (grid[..., 0] - ident_x) * (w - 1) / 2
    v = (grid[..., 1] - ident_y) * (h - 1) / 2
    return np.stack([u, v], axis=-1)


def flow2fig(grid: np.ndarray) -> np.ndarray:
    """(H, W, 2) warp grid -> (H, W, 3) uint8 colour picture of its motion."""
    return flow_to_color(grid_to_flow(grid))


def conf2fig(conf: np.ndarray) -> np.ndarray:
    """(H, W, 1) or (H, W) confidence in [0, 1] -> uint8 grayscale image."""
    c = np.asarray(conf)
    if c.ndim == 3:
        c = c[..., 0]
    return (np.clip(c, 0, 1) * 255).astype(np.uint8)


def _draw_line(img: np.ndarray, y0: float, x0: float, y1: float, x1: float,
               value: float = 0.0) -> None:
    """Rasterise one segment in place on a float grayscale image."""
    n = int(max(abs(y1 - y0), abs(x1 - x0), 1)) * 2 + 1
    ys, xs = np.linspace(y0, y1, n), np.linspace(x0, x1, n)
    h, w = img.shape
    ok = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    img[np.round(ys[ok]).astype(int), np.round(xs[ok]).astype(int)] = value


def grid2fig(warped_grid: np.ndarray, grid_size: int = 32, img_size: int = 256) -> np.ndarray:
    """Warped coordinate grid (h, w, 2) in [-1, 1] -> (img_size, img_size, 3)
    uint8: black lines of the backward-warp lattice on white, subsampled to
    grid_size points a side."""
    g = np.asarray(warped_grid, np.float64)
    if g.shape[0] != grid_size or g.shape[1] != grid_size:
        ys = np.linspace(0, g.shape[0] - 1, grid_size).round().astype(int)
        xs = np.linspace(0, g.shape[1] - 1, grid_size).round().astype(int)
        g = g[np.ix_(ys, xs)]
    px = (g[..., 0] + 1.0) / 2.0 * (img_size - 1)
    py = (g[..., 1] + 1.0) / 2.0 * (img_size - 1)
    img = np.ones((img_size, img_size), np.float32)
    for i in range(grid_size):
        for j in range(grid_size):
            if j + 1 < grid_size:
                _draw_line(img, py[i, j], px[i, j], py[i, j + 1], px[i, j + 1])
            if i + 1 < grid_size:
                _draw_line(img, py[i, j], px[i, j], py[i + 1, j], px[i + 1, j])
    out = (img * 255).astype(np.uint8)
    return np.stack([out] * 3, axis=-1)
