"""Device-side batch expansion for the compact (uint8) wire format.

Counterpart of ``hrviton_tpu/data/device.py``. The host emits only what needs
PIL (decode, resize, agnostic drawing) as uint8, and the normalize / one-hot /
composite math of the reference's per-sample preprocessing (reference
cp_dataset.py:118-244) runs on the batch's device with the same formulas:

  image   = u8 * (2/255) - 1                  (ToTensor+Normalize(.5,.5))
  parse   = onehot(group_idx, semantic_nc)    (cp_dataset.py:150-177)
  pcm     = parse[..., 3:4]
  parse_cloth = image * pcm + (1 - pcm)       (cp_dataset.py:194-195)

``to_device`` brings the loader's numpy arrays there first. On the card each
array is staged through page-locked host memory and copied without the host
waiting for the stream, so that a request's upload queues behind the forward
still running instead of holding the host until the stream drains.

Imports neither PIL nor msgpack: it is what runs on the card.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from hrviton_tpu_torch.ops.parse import onehot
from hrviton_tpu_torch.utils import profiling

__all__ = ["expand_compact", "COMPACT_KEYS", "to_device"]

# keys a compact batch carries instead of the full-contract keys
COMPACT_KEYS = ("parse_idx", "parse_agnostic_idx")

_SCALE = float(np.float32(2.0 / 255.0))   # the f32 factor the JAX package uses


def _img(u8: torch.Tensor, dtype) -> torch.Tensor:
    return (u8.float() * _SCALE - 1.0).to(dtype)


def _labels13(idx_u8: torch.Tensor, semantic_nc: int, dtype) -> torch.Tensor:
    if semantic_nc < 13:
        raise ValueError(f"semantic_nc={semantic_nc} < 13")
    oh = onehot(idx_u8, 13, dtype=dtype)
    if semantic_nc > 13:
        oh = torch.nn.functional.pad(oh, (0, semantic_nc - 13))
    return oh


def expand_compact(batch: Mapping, semantic_nc: int = 13,
                   dtype=torch.float32) -> Dict:
    """Compact uint8 batch (N-stacked VitonHDDataset(compact=True) samples,
    string keys dropped, as tensors) -> the full reference dict contract, on
    the tensors' device."""
    out: Dict = {}
    # cloth keys may be nested ({'paired': ...}) or pre-flattened
    if isinstance(batch["cloth"], Mapping):
        out["cloth"] = {k: _img(v, dtype) for k, v in batch["cloth"].items()}
        out["cloth_mask"] = {k: v.to(dtype)
                             for k, v in batch["cloth_mask"].items()}
    else:
        out["cloth"] = _img(batch["cloth"], dtype)
        out["cloth_mask"] = batch["cloth_mask"].to(dtype)
    parse13 = _labels13(batch["parse_idx"], semantic_nc, dtype)
    out["parse"] = parse13
    out["parse_onehot"] = batch["parse_idx"].to(torch.int32)
    out["parse_agnostic"] = _labels13(batch["parse_agnostic_idx"],
                                      semantic_nc, dtype)
    image = _img(batch["image"], dtype)
    out["image"] = image
    pcm = parse13[..., 3:4]
    out["pcm"] = pcm
    out["parse_cloth"] = image * pcm + (1.0 - pcm)
    out["densepose"] = _img(batch["densepose"], dtype)
    out["pose"] = _img(batch["pose"], dtype)
    if "agnostic" in batch:
        out["agnostic"] = _img(batch["agnostic"], dtype)
    return out


def to_device(batch: Mapping, device) -> Dict:
    """A loader batch of numpy arrays (nested one level) -> tensors on
    ``device``; other values (the name lists) pass through.

    On a CUDA device the host copies each array into page-locked memory
    (torch's caching host allocator: a block is handed out again once
    the copies that read it have ended, so after the first requests nothing
    is page-locked anew), then to a fresh device tensor with
    ``non_blocking`` on the caller's current stream. The call returns when
    the host has staged the last array, without waiting for the stream: the
    caller may overwrite its arrays at once, and each copy runs while the
    next array is staged. Elsewhere (the CPU) a plain copy. Its span,
    ``to_device``, holds the staging and the enqueue."""
    device = torch.device(device)
    pinned = device.type == "cuda"

    def move(v):
        if isinstance(v, Mapping):
            return {k: move(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            if not pinned:
                return t.to(device)
            staged = torch.empty_like(t, pin_memory=True)
            # numpy copies on this thread alone: torch's copy runs a parallel
            # region, and on a shared host a descheduled worker of it held
            # some requests back by tens of ms
            np.copyto(staged.numpy(), v)
            return staged.to(device, non_blocking=True)
        return v
    with profiling.span("to_device"):
        return {k: move(v) for k, v in batch.items()}
