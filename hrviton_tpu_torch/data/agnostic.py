"""Cloth-agnostic person construction + parse-agnostic preprocessing.

Counterpart of ``hrviton_tpu/data/agnostic.py``: host-side (PIL/NumPy)
preprocessing with behavioral parity to:
  * CPDataset.get_agnostic (reference cp_dataset.py:49-116): paint gray
    primitives over torso/neck/arms guided by OpenPose keypoints, then restore
    un-occluded head / lower-body / arm pixels from the original photo.
  * get_im_parse_agnostic (reference get_parse_agnostic.py:13-43): blank
    out upper-clothes/neck/arm labels from the parse map (offline C17 tool).

These run on the host in loader workers; the card never sees PIL objects.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw

__all__ = ["build_cloth_agnostic", "build_parse_agnostic"]

_GRAY = (128, 128, 128)

# CIHP label ids used below
_HEAD_LABELS = (4, 13)
_LOWER_LABELS = (9, 12, 16, 17, 18, 19)
_UPPER_LABELS = (5, 6, 7)
_NECK_LABEL = 10
_LEFT_ARM, _RIGHT_ARM = 14, 15


def _label_mask_bool(parse_array: np.ndarray, labels) -> np.ndarray:
    """Boolean union of parse labels (labels are disjoint per pixel, so this
    equals the reference's accumulate-and-clip float math exactly)."""
    m = parse_array == labels[0]
    for l in labels[1:]:
        m |= parse_array == l
    return m


def _mask_u8(mask_bool: np.ndarray) -> Image.Image:
    return Image.fromarray(mask_bool.astype(np.uint8) * np.uint8(255), "L")


def _valid(p) -> bool:
    return not (p[0] == 0.0 and p[1] == 0.0)


def build_cloth_agnostic(im: Image.Image, im_parse: Image.Image,
                         pose_data: np.ndarray) -> Image.Image:
    """Gray out the clothing region of a person photo (cp_dataset.py:49-116).

    Args:
      im: person photo (RGB, full resolution, e.g. 768x1024).
      im_parse: CIHP parse map, same resolution ('P' or 'L' PIL image).
      pose_data: (25, 2) OpenPose BODY_25 keypoints in image pixels; mutated
        in-place like the reference (hips re-scaled to shoulder width).
    """
    parse_array = np.array(im_parse)
    head_mask = _label_mask_bool(parse_array, _HEAD_LABELS)
    lower_mask = _label_mask_bool(parse_array, _LOWER_LABELS)

    agnostic = im.copy()
    draw = ImageDraw.Draw(agnostic)

    shoulder_w = np.linalg.norm(pose_data[5] - pose_data[2])
    hip_w = np.linalg.norm(pose_data[12] - pose_data[9])
    hip_mid = (pose_data[9] + pose_data[12]) / 2
    # re-scale hip span to shoulder width so torso primitives cover the body
    pose_data[9] = hip_mid + (pose_data[9] - hip_mid) / hip_w * shoulder_w
    pose_data[12] = hip_mid + (pose_data[12] - hip_mid) / hip_w * shoulder_w

    r = int(shoulder_w / 16) + 1

    # torso: hip ellipses, shoulder->hip strokes, hip bar, quad fill
    for i in (9, 12):
        px, py = pose_data[i]
        draw.ellipse((px - r * 3, py - r * 6, px + r * 3, py + r * 6), _GRAY, _GRAY)
    draw.line([tuple(pose_data[2]), tuple(pose_data[9])], _GRAY, width=r * 6)
    draw.line([tuple(pose_data[5]), tuple(pose_data[12])], _GRAY, width=r * 6)
    draw.line([tuple(pose_data[9]), tuple(pose_data[12])], _GRAY, width=r * 12)
    draw.polygon([tuple(pose_data[i]) for i in (2, 5, 12, 9)], _GRAY, _GRAY)

    # neck box above keypoint 1
    px, py = pose_data[1]
    draw.rectangle((px - r * 5, py - r * 9, px + r * 5, py), _GRAY, _GRAY)

    # arms: shoulder bar + per-joint strokes and caps
    draw.line([tuple(pose_data[2]), tuple(pose_data[5])], _GRAY, width=r * 12)
    for i in (2, 5):
        px, py = pose_data[i]
        draw.ellipse((px - r * 5, py - r * 6, px + r * 5, py + r * 6), _GRAY, _GRAY)
    for i in (3, 4, 6, 7):
        if not (_valid(pose_data[i - 1]) and _valid(pose_data[i])):
            continue
        draw.line([tuple(pose_data[i - 1]), tuple(pose_data[i])], _GRAY, width=r * 10)
        px, py = pose_data[i]
        draw.ellipse((px - r * 5, py - r * 5, px + r * 5, py + r * 5), _GRAY, _GRAY)

    # restore forearm/hand pixels that the parse map attributes to arms but the
    # drawn arm-occluder does not cover (cp_dataset.py:96-112)
    size = im.size  # reference hardcodes (768, 1024) here; use the actual size
    for parse_id, pose_ids in ((_LEFT_ARM, (5, 6, 7)), (_RIGHT_ARM, (2, 3, 4))):
        occluder = Image.new("L", size, "white")
        occ_draw = ImageDraw.Draw(occluder)
        px, py = pose_data[pose_ids[0]]
        occ_draw.ellipse((px - r * 5, py - r * 6, px + r * 5, py + r * 6),
                         "black", "black")
        for i in pose_ids[1:]:
            if not (_valid(pose_data[i - 1]) and _valid(pose_data[i])):
                continue
            occ_draw.line([tuple(pose_data[i - 1]), tuple(pose_data[i])],
                          "black", width=r * 10)
            px, py = pose_data[i]
            if i != pose_ids[-1]:
                occ_draw.ellipse((px - r * 5, py - r * 5, px + r * 5, py + r * 5),
                                 "black", "black")
        occ_draw.ellipse((px - r * 4, py - r * 4, px + r * 4, py + r * 4),
                         "black", "black")

        # both masks are binary, so uint8/bool math == the reference's
        # float64 (occluder/255) * mask composition, pixel-exact
        keep = (np.asarray(occluder) != 0) & (parse_array == parse_id)
        agnostic.paste(im, None, _mask_u8(keep))

    agnostic.paste(im, None, _mask_u8(head_mask))
    agnostic.paste(im, None, _mask_u8(lower_mask))
    return agnostic


def build_parse_agnostic(im_parse: Image.Image, pose_data: np.ndarray,
                         w: int = 768, h: int = 1024) -> Image.Image:
    """Blank upper-clothes/neck/arms from a parse map (get_parse_agnostic.py:13-43)."""
    parse_array = np.array(im_parse)
    upper_mask = _label_mask_bool(parse_array, _UPPER_LABELS)
    neck_mask = _label_mask_bool(parse_array, (_NECK_LABEL,))

    r = 10
    agnostic = im_parse.copy()

    for parse_id, pose_ids in ((_LEFT_ARM, (2, 5, 6, 7)),
                               (_RIGHT_ARM, (5, 2, 3, 4))):
        arm_region = Image.new("L", (w, h), "black")
        arm_draw = ImageDraw.Draw(arm_region)
        i_prev = pose_ids[0]
        px = py = 0.0
        for i in pose_ids[1:]:
            if not (_valid(pose_data[i_prev]) and _valid(pose_data[i])):
                continue
            arm_draw.line([tuple(pose_data[i_prev]), tuple(pose_data[i])],
                          "white", width=r * 10)
            px, py = pose_data[i]
            radius = r * 4 if i == pose_ids[-1] else r * 15
            arm_draw.ellipse((px - radius, py - radius, px + radius, py + radius),
                             "white", "white")
            i_prev = i
        erase = (np.asarray(arm_region) != 0) & (parse_array == parse_id)
        agnostic.paste(0, None, _mask_u8(erase))

    agnostic.paste(0, None, _mask_u8(upper_mask))
    agnostic.paste(0, None, _mask_u8(neck_mask))
    return agnostic
