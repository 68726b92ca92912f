"""Human-parse label remapping and one-hot utilities.

Counterpart of ``hrviton_tpu/ops/parse.py``. Encodes the two label
regroupings of the reference pipeline:
  * 20-channel CIHP parse -> 13-channel training labels
    (reference cp_dataset.py:150-172)
  * 13-channel predicted segmap -> 7-channel SPADE conditioning labels
    (reference test_generator.py:188-203, train_generator.py:261-273)

Remaps are static 0/1 matrices applied with one einsum; the label-id forms
(``group_index_of_label20`` / ``13``) are lookup tables. Both are copied to
a device once (``core/graphs.constant``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hrviton_tpu_torch.core import graphs, precision

__all__ = [
    "LABELS_20_TO_13", "LABELS_13_TO_7", "remap_matrix", "onehot",
    "remap_parse", "parse20_to_13", "parse13_to_7", "group_index_of_label20",
    "group_index_of_label13", "lut_lookup",
]

# 13-way training groups over the 20 CIHP labels (cp_dataset.py:150-164).
LABELS_20_TO_13 = {
    0: [0, 10],        # background
    1: [1, 2],         # hair
    2: [4, 13],        # face
    3: [5, 6, 7],      # upper
    4: [9, 12],        # bottom
    5: [14],           # left_arm
    6: [15],           # right_arm
    7: [16],           # left_leg
    8: [17],           # right_leg
    9: [18],           # left_shoe
    10: [19],          # right_shoe
    11: [8],           # socks
    12: [3, 11],       # noise
}

# 7-way SPADE conditioning groups over the 13 labels (test_generator.py:188-196).
LABELS_13_TO_7 = {
    0: [0],                      # background
    1: [2, 4, 7, 8, 9, 10, 11],  # paste
    2: [3],                      # upper
    3: [1],                      # hair
    4: [5],                      # left_arm
    5: [6],                      # right_arm
    6: [12],                     # noise
}

_SPECS = {"20to13": (LABELS_20_TO_13, 20), "13to7": (LABELS_13_TO_7, 13)}


@functools.lru_cache(maxsize=None)
def remap_matrix(spec_name: str) -> np.ndarray:
    """(dst, src) 0/1 matrix of the named regrouping."""
    spec, src_n = _SPECS[spec_name]
    mat = np.zeros((len(spec), src_n), dtype=np.float32)
    for dst, srcs in spec.items():
        for s in srcs:
            mat[dst, s] = 1.0
    return mat


def _group_table(spec_name: str) -> np.ndarray:
    spec, src_n = _SPECS[spec_name]
    table = np.zeros((src_n,), dtype=np.int32)
    for dst, srcs in spec.items():
        for s in srcs:
            table[s] = dst
    return table


def onehot(labels: torch.Tensor, num_classes: int,
           dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) int labels -> (N, H, W, num_classes) one-hot."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None].long() == classes).to(dtype)


def remap_parse(parse_onehot: torch.Tensor, spec_name: str) -> torch.Tensor:
    """(N, H, W, src) one-hot(ish) map -> grouped (N, H, W, dst) map."""
    mat = graphs.constant(remap_matrix(spec_name), parse_onehot.device,
                          parse_onehot.dtype)
    with precision.exact(parse_onehot.dtype):
        return torch.einsum("ds,nhws->nhwd", mat, parse_onehot)


def parse20_to_13(labels20: torch.Tensor) -> torch.Tensor:
    """(N, H, W) int CIHP labels -> (N, H, W, 13) grouped one-hot."""
    return remap_parse(onehot(labels20, 20), "20to13")


def parse13_to_7(seg13_onehot: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 13) one-hot segmap -> (N, H, W, 7) SPADE conditioning map."""
    return remap_parse(seg13_onehot, "13to7")


@functools.lru_cache(maxsize=None)
def group_index_of_label13() -> np.ndarray:
    """Lookup table: 13-label id -> 7-group id. For one-hot inputs,
    ``onehot(lut[labels], 7) == parse13_to_7(onehot(labels, 13))`` exactly."""
    return _group_table("13to7")


@functools.lru_cache(maxsize=None)
def group_index_of_label20() -> np.ndarray:
    """Lookup table: raw 20-label id -> 13-group id (the reference's
    ``parse_onehot`` CE target, cp_dataset.py:174-177)."""
    return _group_table("20to13")


def lut_lookup(labels: torch.Tensor, table) -> torch.Tensor:
    """``table[labels]`` as int32."""
    t = graphs.constant(table, labels.device, torch.int32)
    return t[labels.long()]
