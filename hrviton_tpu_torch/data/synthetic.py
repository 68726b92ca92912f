"""Synthetic VITON-HD fixture: the full directory layout of SURVEY.md §3.4
with procedurally drawn samples, so the data layer and the CLIs run without
the real dataset.

Counterpart of ``hrviton_tpu/data/synthetic.py``: the same seed writes the
same files, bytes and pair lists."""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
from PIL import Image, ImageDraw

__all__ = ["make_synthetic_dataset"]

# CIHP-style palette so parse PNGs are valid 'P' images
_PALETTE = []
for i in range(256):
    _PALETTE += [(i * 37) % 256, (i * 91) % 256, (i * 53) % 256]


def _pose_points(w: int, h: int) -> np.ndarray:
    """Plausible BODY_25 keypoints for a centered standing figure."""
    pts = np.zeros((25, 3), dtype=np.float64)
    cx = w / 2
    pts[0] = (cx, h * 0.10, 1)           # nose
    pts[1] = (cx, h * 0.20, 1)           # neck
    pts[2] = (cx - w * 0.18, h * 0.22, 1)  # r shoulder
    pts[3] = (cx - w * 0.24, h * 0.38, 1)  # r elbow
    pts[4] = (cx - w * 0.26, h * 0.52, 1)  # r wrist
    pts[5] = (cx + w * 0.18, h * 0.22, 1)  # l shoulder
    pts[6] = (cx + w * 0.24, h * 0.38, 1)  # l elbow
    pts[7] = (cx + w * 0.26, h * 0.52, 1)  # l wrist
    pts[8] = (cx, h * 0.52, 1)           # mid hip
    pts[9] = (cx - w * 0.10, h * 0.52, 1)  # r hip
    pts[10] = (cx - w * 0.10, h * 0.72, 1)
    pts[11] = (cx - w * 0.10, h * 0.92, 1)
    pts[12] = (cx + w * 0.10, h * 0.52, 1)  # l hip
    pts[13] = (cx + w * 0.10, h * 0.72, 1)
    pts[14] = (cx + w * 0.10, h * 0.92, 1)
    return pts


def _draw_parse(w: int, h: int, rng) -> Image.Image:
    """Parse map with head(13), upper(5), arms(14/15), legs(16/17), hair(2)."""
    img = Image.new("P", (w, h), 0)
    d = ImageDraw.Draw(img)
    cx = w // 2
    d.ellipse((cx - w // 8, h // 30, cx + w // 8, h // 6), fill=13)     # face
    d.rectangle((cx - w // 8, h // 40, cx + w // 8, h // 12), fill=2)   # hair
    d.rectangle((cx - w // 4, h // 5, cx + w // 4, h // 2), fill=5)     # upper
    d.rectangle((cx - w // 3, h // 5, cx - w // 4, h // 2), fill=14)    # l arm
    d.rectangle((cx + w // 4, h // 5, cx + w // 3, h // 2), fill=15)    # r arm
    d.rectangle((cx - w // 4, h // 2, cx - w // 20, int(h * .92)), fill=16)
    d.rectangle((cx + w // 20, h // 2, cx + w // 4, int(h * .92)), fill=17)
    d.rectangle((cx - w // 6, int(h * 0.16), cx + w // 6, h // 5), fill=10)  # neck
    img.putpalette(_PALETTE)
    return img


def make_synthetic_dataset(root: str, n: int = 4, w: int = 768, h: int = 1024,
                           modes=("train", "test"), seed: int = 0) -> str:
    """Write a synthetic VITON-HD tree under `root`; returns root."""
    rng = np.random.default_rng(seed)
    for mode in modes:
        base = osp.join(root, mode)
        for sub in ("image", "image-parse-v3", "image-parse-agnostic-v3.2",
                    "cloth", "cloth-mask", "openpose_img", "openpose_json",
                    "image-densepose"):
            os.makedirs(osp.join(base, sub), exist_ok=True)

        # VITON-HD-style numeric names ("00013_00.jpg"): evaluate.py derives the
        # ground-truth name as pred.split('_')[0] + '_00.jpg'
        names = [f"{i:05d}_00.jpg" for i in range(n)]
        pairs = []
        for i, name in enumerate(names):
            png = name.replace(".jpg", ".png")

            person = (rng.uniform(80, 220, (h, w, 3))).astype(np.uint8)
            Image.fromarray(person).save(osp.join(base, "image", name))

            parse = _draw_parse(w, h, rng)
            parse.save(osp.join(base, "image-parse-v3", png))

            agn = parse.copy()
            d = ImageDraw.Draw(agn)
            d.rectangle((w // 4, h // 5, 3 * w // 4, h // 2), fill=0)
            agn.save(osp.join(base, "image-parse-agnostic-v3.2", png))

            cloth = (rng.uniform(0, 255, (h, w, 3))).astype(np.uint8)
            Image.fromarray(cloth).save(osp.join(base, "cloth", name))
            cmask = np.zeros((h, w), np.uint8)
            cmask[h // 5:h // 2, w // 4:3 * w // 4] = 255
            Image.fromarray(cmask).save(osp.join(base, "cloth-mask", name))

            pose_img = (rng.uniform(0, 60, (h, w, 3))).astype(np.uint8)
            Image.fromarray(pose_img).save(
                osp.join(base, "openpose_img", name.replace(".jpg", "_rendered.png")))

            pts = _pose_points(w, h)
            blob = {"people": [{"pose_keypoints_2d":
                                [float(v) for v in pts.reshape(-1)]}]}
            with open(osp.join(base, "openpose_json",
                               name.replace(".jpg", "_keypoints.json")), "w") as f:
                json.dump(blob, f)

            dp = (rng.uniform(0, 255, (h, w, 3))).astype(np.uint8)
            Image.fromarray(dp).save(osp.join(base, "image-densepose", name))

            partner = names[(i + 1) % n]
            pairs.append(f"{name} {partner}")

        with open(osp.join(root, f"{mode}_pairs.txt"), "w") as f:
            f.write("\n".join(pairs) + "\n")
    return root
