"""Visualization & image-saving utilities.

Counterpart of ``hrviton_tpu/utils/vis.py``. Parity targets: segmap palette
visualizer (reference utils.py:49-70), torchvision-style image grids
(train_condition.py:377-380), and save_images (utils.py:93-109). All
functions take NHWC numpy arrays or CPU tensors. PIL is imported inside
``save_images`` only; the palette lookup gives the RGB that PIL's
``putpalette`` -> ``convert("RGB")`` gives (labels past the palette: black).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

__all__ = ["SEG_PALETTE", "visualize_segmap", "make_image_grid", "save_images",
           "to_uint8"]

# 20-entry palette (utils.py:50-55), RGB triplets
SEG_PALETTE = [
    0, 0, 0, 128, 0, 0, 254, 0, 0, 0, 85, 0, 169, 0, 51,
    254, 85, 0, 0, 0, 85, 0, 119, 220, 85, 85, 0, 0, 85, 85,
    85, 51, 0, 52, 86, 128, 0, 128, 0, 0, 0, 254, 51, 169, 220,
    0, 254, 254, 85, 254, 169, 169, 254, 85, 254, 254, 0, 254, 169, 0,
]

_PALETTE_RGB = np.zeros((256, 3), np.uint8)
_PALETTE_RGB[:len(SEG_PALETTE) // 3] = np.reshape(SEG_PALETTE, (-1, 3))


def visualize_segmap(segmap, batch: int = 0) -> np.ndarray:
    """(N, H, W, C) channel map -> (H, W, 3) palette RGB float in [0, 1]."""
    seg = np.asarray(segmap[batch])
    labels = seg.argmax(-1).astype(np.uint8)
    return _PALETTE_RGB[labels].astype(np.float32) / 255.0


def to_uint8(img) -> np.ndarray:
    """[-1, 1] float image -> uint8 (utils.py:95-96 semantics)."""
    arr = (np.asarray(img, dtype=np.float32) + 1.0) * 0.5 * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def make_image_grid(images: Sequence[np.ndarray], nrow: int = 4,
                    pad: int = 2) -> np.ndarray:
    """Tile (H, W, 3) float[0,1] images into a grid (torchvision make_grid)."""
    imgs = [np.asarray(im, dtype=np.float32) for im in images]
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    norm = []
    for im in imgs:
        if im.ndim == 2:
            im = im[..., None]
        if im.shape[-1] == 1:
            im = np.repeat(im, 3, axis=-1)
        canvas = np.zeros((h, w, 3), np.float32)
        canvas[:im.shape[0], :im.shape[1]] = im
        norm.append(canvas)
    ncol = nrow
    nrows = (len(norm) + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, 3),
                    np.float32)
    for i, im in enumerate(norm):
        r, c = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        grid[y:y + h, x:x + w] = im
    return np.clip(grid, 0.0, 1.0)


def save_images(img_tensors, img_names: Sequence[str], save_dir: str) -> None:
    """Batch of [-1,1] NHWC images -> JPEG files (utils.py:93-109)."""
    from PIL import Image
    os.makedirs(save_dir, exist_ok=True)
    for img, name in zip(np.asarray(img_tensors), img_names):
        arr = to_uint8(img)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        Image.fromarray(arr).save(os.path.join(save_dir, name), format="JPEG")
