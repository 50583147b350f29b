"""Image, grid, frame-sequence, GIF, video and PLY export (counterpart of
``utils/saving.py``). PNGs are written with the standard library's
``zlib``; the turntable's GIF needs PIL, imported where it is written, and
its video imageio with an ffmpeg plugin, without which it falls back to a
GIF, as in the JAX package."""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np


def to_uint8(img) -> np.ndarray:
    """Float [0, 1] (or uint8) HxW or HxWx3 -> uint8 HxWx3."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img


def save_image(path: str, img) -> str:
    """8-bit RGB PNG."""
    rgb = to_uint8(img)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
    return path


def save_video_frames(dirname: str, frames: Iterable) -> list:
    return [save_image(os.path.join(dirname, f"{i:04d}.png"), f)
            for i, f in enumerate(frames)]


def save_gif(path: str, frames: Sequence, fps: int = 20) -> str:
    """An animated GIF of float [0, 1] (or uint8) frames, looping."""
    import PIL.Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [PIL.Image.fromarray(to_uint8(f)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path


def save_video(path: str, frames: Sequence, fps: int = 20) -> str:
    """A video through imageio's ffmpeg plugin; where imageio or a backend
    for the file's extension is missing, a GIF beside it instead. Returns
    the path written."""
    try:
        import imageio.v2 as imageio

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(to_uint8(f))
        return path
    except (ImportError, ValueError):   # ValueError: no backend for it
        return save_gif(os.path.splitext(path)[0] + ".gif", frames, fps=fps)


def save_image_grid(path: str, imgs: Sequence, cols: Optional[int] = None
                    ) -> str:
    """Equal-sized images in a grid of ``cols`` columns (all in one row by
    default), row by row."""
    imgs = [to_uint8(i) for i in imgs]
    h, w = imgs[0].shape[:2]
    cols = cols or len(imgs)
    rows = -(-len(imgs) // cols)
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for k, im in enumerate(imgs):
        r, c = divmod(k, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return save_image(path, grid)


class Saver:
    """Writes a run's images and PLYs under one directory."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    def path(self, *parts: str) -> str:
        p = os.path.join(self.save_dir, *parts)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        return p

    def save_rgb(self, name: str, img) -> str:
        return save_image(self.path(name), img)

    def save_grid(self, name: str, imgs, cols: Optional[int] = None) -> str:
        return save_image_grid(self.path(name), imgs, cols)

    def save_ply(self, name: str, gaussians) -> str:
        p = self.path(name)
        gaussians.to_ply(p)
        return p
