"""Device-side batch expansion for the compact (uint8) wire format.

Counterpart of ``hrviton_tpu/data/device.py``. The host emits only what needs
PIL (decode, resize, agnostic drawing) as uint8, and the normalize / one-hot /
composite math of the reference's per-sample preprocessing (reference
cp_dataset.py:118-244) runs on the batch's device with the same formulas:

  image   = u8 * (2/255) - 1                  (ToTensor+Normalize(.5,.5))
  parse   = onehot(group_idx, semantic_nc)    (cp_dataset.py:150-177)
  pcm     = parse[..., 3:4]
  parse_cloth = image * pcm + (1 - pcm)       (cp_dataset.py:194-195)

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
    ``device``; other values (the name lists) pass through. Its span,
    ``to_device``, holds the pageable copies and the host's wait for them."""
    def move(v):
        if isinstance(v, Mapping):
            return {k: move(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return torch.from_numpy(v).to(device)
        return v
    with profiling.span("to_device"):
        return {k: move(v) for k, v in batch.items()}
