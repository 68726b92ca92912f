"""VITON-HD dataset reader (counterpart of ``hrviton_tpu/data/dataset.py``).

Produces the exact per-sample dict contract of the reference loaders
(reference cp_dataset.py:223-242, cp_dataset_test.py:219-241), as NHWC
float32 numpy arrays in [-1, 1] (images) / {0, 1} (masks) / one-hot maps:

  keys: 'cloth' {'paired','unpaired'}, 'cloth_mask' {...}, 'parse_agnostic'
  (13ch), 'densepose', 'pose', 'agnostic' (train/generator-test flavors),
  'parse_onehot' (int index map), 'parse' (13ch), 'pcm', 'parse_cloth',
  'image', 'im_name', 'c_name'.

Directory layout (SURVEY.md §3.4):
  {dataroot}/{datamode}/{image, image-parse-v3, image-parse-agnostic-v3.2,
  cloth, cloth-mask, openpose_img, openpose_json, image-densepose}
  {dataroot}/{data_list} with "im_name c_name" lines.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List

import numpy as np
from PIL import Image

from hrviton_tpu_torch.config import DataConfig
from hrviton_tpu_torch.data.agnostic import build_cloth_agnostic
from hrviton_tpu_torch.ops.parse import LABELS_20_TO_13

__all__ = ["VitonHDDataset"]

# Sentinel-initialized LUT: labels outside the reference's 20-label space must
# fail loudly, not silently map to background (cp_dataset.py:150-172 only ever
# sees labels 0..19).
_LUT_SENTINEL = -1
_LABEL20_LUT = np.full(256, _LUT_SENTINEL, np.int32)
for _dst, _srcs in LABELS_20_TO_13.items():
    for _s in _srcs:
        _LABEL20_LUT[_s] = _dst


def _to_unit(img: Image.Image) -> np.ndarray:
    """HWC float in [-1, 1] (ToTensor + Normalize(.5,.5) parity).

    In-place arithmetic on a fresh f32 copy — measurably faster than either
    chained expressions or a uint8 LUT gather on bandwidth-poor hosts (this
    runs 5x per sample and was a top loader-profile entry)."""
    return _to_unit_from_u8(np.asarray(img))


def _to_unit_from_u8(arr_u8: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr_u8, dtype=np.float32)
    arr *= np.float32(2.0 / 255.0)
    arr -= np.float32(1.0)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _resize(img: Image.Image, w: int, h: int, nearest: bool = False) -> Image.Image:
    if img.size == (w, h):
        return img
    return img.resize((w, h), Image.NEAREST if nearest else Image.BILINEAR)


class VitonHDDataset:
    """Map-style dataset over a VITON-HD directory tree.

    Flavors (reference classes they correspond to):
      * mode='train'    -> CPDataset (paired cloth only, agnostic included)
      * mode='test'     -> CPDatasetTest of cp_dataset.py (paired+unpaired, no
                           agnostic) — the condition-stage test flavor
      * mode='test_gen' -> CPDatasetTest of cp_dataset_test.py (paired+unpaired
                           + agnostic) — the generator-stage test flavor
    """

    def __init__(self, cfg: DataConfig, mode: str = "train",
                 compact: bool = False):
        """compact=True emits the compact wire format: uint8 images and
        uint8 group-label maps instead of f32 [-1,1] arrays and one-hot
        channels. The normalize / one-hot / pcm / parse_cloth math moves to
        the device via data.device.expand_compact (bit-identical formulas),
        cutting host time per sample and host->device bytes 4x.
        Keys change: 'parse'/'parse_agnostic'/'parse_onehot'/'pcm'/
        'parse_cloth' are replaced by 'parse_idx'/'parse_agnostic_idx'."""
        if mode not in ("train", "test", "test_gen"):
            raise ValueError(mode)
        self.cfg = cfg
        self.mode = mode
        self.compact = compact
        self.h, self.w = cfg.fine_height, cfg.fine_width
        self.data_path = osp.join(cfg.dataroot, cfg.datamode)

        im_names: List[str] = []
        c_names: List[str] = []
        with open(osp.join(cfg.dataroot, cfg.data_list)) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                im_names.append(parts[0])
                c_names.append(parts[1] if len(parts) > 1 else parts[0])
        self.im_names = im_names
        self.c_names = {"paired": im_names, "unpaired": c_names}

    def __len__(self) -> int:
        return len(self.im_names)

    # ---- per-component loaders ------------------------------------------------

    def _cloth(self, c_name: str):
        c = Image.open(osp.join(self.data_path, "cloth", c_name)).convert("RGB")
        cm = Image.open(osp.join(self.data_path, "cloth-mask", c_name))
        cm = np.asarray(_resize(cm, self.w, self.h, nearest=True))
        if cm.ndim == 3:
            cm = cm[..., 0]
        if self.compact:
            c = np.asarray(_resize(c, self.w, self.h))
            return c, (cm >= 128).astype(np.uint8)[..., None]
        c = _to_unit(_resize(c, self.w, self.h))
        cm = (cm >= 128).astype(np.float32)[..., None]
        return c, cm

    def _parse_index(self, labels20: np.ndarray) -> np.ndarray:
        """20-label map -> 13-group index map with loud validation."""
        index_map = _LABEL20_LUT[labels20]
        if index_map.min() == _LUT_SENTINEL:
            bad = np.unique(labels20[index_map == _LUT_SENTINEL])
            raise ValueError(
                f"parse map contains labels {bad.tolist()} outside the "
                "reference's 20-label space (cp_dataset.py:150-172)")
        return index_map

    def _parse_maps(self, labels20: np.ndarray):
        """20-label map -> (13ch one-hot, int group-index map) (cp_dataset.py:150-177).

        The 20 source labels partition into the 13 groups, so a LUT gather +
        eye-row gather reproduces the reference's accumulate-per-source loop
        exactly (each pixel holds one source label) at ~20x the speed."""
        index_map = self._parse_index(labels20)
        onehot13 = np.zeros((self.h, self.w, 13), np.float32)
        np.put_along_axis(onehot13, index_map[..., None], 1.0, axis=-1)
        if self.cfg.semantic_nc < 13:
            # truncation would keep group indices >= semantic_nc in index_map
            # while dropping their one-hot channels — refuse rather than emit
            # an inconsistent pair
            raise ValueError(
                f"semantic_nc={self.cfg.semantic_nc} < 13: the 20->13 remap "
                "cannot be truncated consistently")
        if self.cfg.semantic_nc > 13:
            out = np.zeros((self.h, self.w, self.cfg.semantic_nc), np.float32)
            out[..., :13] = onehot13
            return out, index_map
        return onehot13, index_map

    def _pose_points(self, im_name: str) -> np.ndarray:
        pose_name = im_name.replace(".jpg", "_keypoints.json")
        with open(osp.join(self.data_path, "openpose_json", pose_name)) as f:
            label = json.load(f)
        pts = np.array(label["people"][0]["pose_keypoints_2d"],
                       dtype=np.float64).reshape(-1, 3)[:, :2]
        return pts

    # ---- sample assembly -------------------------------------------------------

    def __getitem__(self, index: int) -> Dict:
        im_name = self.im_names[index]
        keys = ("paired",) if self.mode == "train" else ("paired", "unpaired")

        c_name, cloth, cloth_mask = {}, {}, {}
        for key in keys:
            c_name[key] = self.c_names[key][index]
            cloth[key], cloth_mask[key] = self._cloth(c_name[key])

        im_pil_big = Image.open(osp.join(self.data_path, "image", im_name))
        im_u8 = np.asarray(_resize(im_pil_big, self.w, self.h))

        parse_name = im_name.replace(".jpg", ".png")
        parse_pil_big = Image.open(
            osp.join(self.data_path, "image-parse-v3", parse_name))
        parse_small = np.asarray(
            _resize(parse_pil_big, self.w, self.h, nearest=True))

        agn_pil = Image.open(osp.join(
            self.data_path, "image-parse-agnostic-v3.2", parse_name))
        agn_small = np.asarray(_resize(agn_pil, self.w, self.h, nearest=True))

        pose_png = im_name.replace(".jpg", "_rendered.png")
        pose_u8 = np.asarray(_resize(
            Image.open(osp.join(self.data_path, "openpose_img", pose_png))
            .convert("RGB"), self.w, self.h))

        densepose_u8 = np.asarray(_resize(
            Image.open(osp.join(self.data_path, "image-densepose", im_name))
            .convert("RGB"), self.w, self.h))

        if self.compact:
            sample = {
                "c_name": c_name,
                "im_name": im_name,
                "cloth": cloth,
                "cloth_mask": cloth_mask,
                "parse_idx": self._parse_index(parse_small).astype(np.uint8),
                "parse_agnostic_idx":
                    self._parse_index(agn_small).astype(np.uint8),
                "densepose": densepose_u8,
                "pose": pose_u8,
                "image": im_u8,
            }
        else:
            parse13, parse_onehot = self._parse_maps(parse_small)
            parse_agnostic13, _ = self._parse_maps(agn_small)
            im = _to_unit_from_u8(im_u8)
            pcm = parse13[..., 3:4]
            parse_cloth = im * pcm + (1.0 - pcm)
            sample = {
                "c_name": c_name,
                "im_name": im_name,
                "cloth": cloth,
                "cloth_mask": cloth_mask,
                "parse_agnostic": parse_agnostic13,
                "densepose": _to_unit_from_u8(densepose_u8),
                "pose": _to_unit_from_u8(pose_u8),
                "parse_onehot": parse_onehot,
                "parse": parse13,
                "pcm": pcm,
                "parse_cloth": parse_cloth,
                "image": im,
            }

        if self.mode in ("train", "test_gen"):
            pose_data = self._pose_points(im_name)
            agnostic = build_cloth_agnostic(
                im_pil_big.convert("RGB"), parse_pil_big, pose_data)
            agn_arr = np.asarray(_resize(agnostic, self.w, self.h))
            sample["agnostic"] = (agn_arr if self.compact
                                  else _to_unit_from_u8(agn_arr))

        return sample
