"""The comparison that decides ``correct``: the program's outputs of sampled
timed requests against the plain reference's on the same inputs.

The reference computes the condition stage from the batch itself, and the
generator from the program's own condition outputs (its warped cloth and
labels): with random weights the argmax of the blurred segmentation flips
at near-ties under any rounding, and a flipped label at the generator's
coarse scales rewrites the modulation of a whole region, so an end-to-end
image gap cannot tell a sound bf16 run from an fp8 one (PERF.md). The
stages are held one by one:

- ``rgb_mae``: the try-on image (rgb in [-1, 1], as it reached the host)
  against the reference generator fed the program's condition outputs;
  mean absolute gap;
- ``warp_mae``: the full-size warped cloth against the reference's; mean
  absolute gap;
- ``seg_mae``: the blurred 13-way segmentation logits against the
  reference's; mean absolute gap over the reference's mean magnitude;
- ``label_mismatch``: pixels whose 7-way label is not the regrouped argmax
  of the program's own blurred logits (exact: limit 0);
- ``label_vs_ref``: pixels that the reference decides and whose 7-way
  label differs from the reference's (exact: limit 0). The reference
  decides a pixel where its best logit lies above the best of every other
  label's by more than the configuration's ``label_margin`` times the
  image's mean logit magnitude: more than twice the widest gap of a logit
  (``seg_max_gap``) that sound runs showed, so that no rounding of a sound
  run can flip the label there.

The first three are the worst sampled image's; the last two are summed over
the sampled images. ``correct``: every number finite and at or under its
limit in the configuration's ``limits``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from benchmark.reference.hrviton import LUT_13_TO_7, labels_of

__all__ = ["NUMBERS", "numbers", "judge", "decided", "seg_max_gap"]

NUMBERS = ("rgb_mae", "warp_mae", "seg_mae", "label_mismatch", "label_vs_ref")


def decided(gauss: torch.Tensor, margin: float) -> torch.Tensor:
    """(N, H, W) bool: where the best of the blurred logits ``gauss``
    (N, H, W, 13) lies above the best logit of every other 7-way label by
    more than ``margin`` times the image's mean logit magnitude."""
    g = gauss.float()
    lut = torch.tensor(LUT_13_TO_7, device=g.device)
    best = lut[g.argmax(-1)]
    other = g.masked_fill(lut == best[..., None], -math.inf).amax(-1)
    scale = g.abs().mean(dim=(1, 2, 3))[:, None, None]
    return g.amax(-1) - other > margin * scale


def seg_max_gap(got: Sequence, want: Sequence) -> float:
    """The widest gap of a blurred logit over its image's mean logit
    magnitude in the reference, worst over the images (the readings that
    ``label_margin`` is set from)."""
    out = 0.0
    for g, w in zip(got, want):
        gap = (g[2].float() - w[2].float()).abs().amax(dim=(1, 2, 3))
        out = max(out, float((gap / w[2].float().abs().mean(dim=(1, 2, 3))).max()))
    return out


def numbers(got: Sequence, want: Sequence, margin: float) -> Dict[str, float]:
    """got, want: sequences of (rgb (N, H, W, 3), warped cloth (N, H, W, 3),
    blurred logits (N, H, W, 13), labels (N, H, W)) for the same requests,
    ``want`` the reference's with its generator fed ``got``'s condition
    outputs; ``margin``: the configuration's ``label_margin``."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for g, w in zip(got, want):
        if any(a.shape != b.shape for a, b in zip(g, w)):
            return dict.fromkeys(NUMBERS, math.inf)
        gap = lambda a, b: (a.float() - b.float()).abs().mean(dim=(1, 2, 3))
        per = {"rgb_mae": gap(g[0], w[0]), "warp_mae": gap(g[1], w[1]),
               "seg_mae": gap(g[2], w[2]) / w[2].float().abs().mean(dim=(1, 2, 3))}
        for k, v in per.items():
            v = torch.nan_to_num(v.double(), nan=math.inf)
            out[k] = max(out[k], float(v.max()))
        out["label_mismatch"] += float((g[3].long() != labels_of(g[2]).long()).sum())
        out["label_vs_ref"] += float(((g[3].long() != w[3].long())
                                      & decided(w[2], margin)).sum())
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k] for k in NUMBERS)
