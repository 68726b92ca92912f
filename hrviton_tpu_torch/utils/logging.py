"""TensorBoard logging with the reference's tag layout (Loss/G,
Loss/G/l1_cloth, val/iou, test/LPIPS, train_images, ...), as
``hrviton_tpu/utils/logging.py``: through tensorboardX where it imports,
else nothing is written (the CLIs print their metrics to stdout)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["Board"]


class Board:
    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
                os.makedirs(log_dir, exist_ok=True)
                self._writer = SummaryWriter(log_dir=log_dir)
            except Exception as e:  # pragma: no cover
                print(f"[board] tensorboard disabled: {e}")

    def scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def scalars(self, metrics: dict, step: int, prefix: str = "") -> None:
        for k, v in metrics.items():
            self.scalar(prefix + k, v, step)

    def image_grid(self, tag: str, grid_hwc: np.ndarray, step: int) -> None:
        """(H, W, 3) float [0, 1] grid."""
        if self._writer is not None:
            self._writer.add_image(tag, np.transpose(grid_hwc, (2, 0, 1)), step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
