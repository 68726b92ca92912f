#!/usr/bin/env python
"""Composed knockout attribution of the condition stage (timing only).

PyTorch counterpart of ``tools/exp_cond_knockout.py``: the condition stage
(``pipelines/tryon.condition_forward``'s work: the downsamples, the tocg,
the clothmask composition, the blur chain, argmax, the 13 -> 7 lookup and
one-hot, the full-size warp) written with switches, each variant replacing
one piece with a stub of the same shape, as the JAX tool's seven do. Each
variant replays a CUDA graph of its own (``core/graphs.captured``) and is
timed in pairs with the full stage. ``main`` first holds the full stage's
outputs against ``condition_forward``'s, bit for bit.

    python -m hrviton_tpu_torch.tools.exp_cond_knockout

Sizes from the KNOCK_* variables (``tools/_knockout.py``).
"""

from __future__ import annotations

import torch

from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.ops.blur import gaussian_blur
from hrviton_tpu_torch.ops.grid_sample import flow_warp
from hrviton_tpu_torch.ops.parse import group_index_of_label13, lut_lookup, onehot
from hrviton_tpu_torch.ops.resize import interpolate, resize_flow
from hrviton_tpu_torch.pipelines.tryon import (compose_clothmask,
                                               condition_forward)
from hrviton_tpu_torch.tools._knockout import (card_name, first_path_pipeline,
                                               in_pairs, knock_size, report,
                                               synthetic_batch)

__all__ = ["VARIANTS", "condition", "full_equals_production", "main"]

# the JAX tool's variants (tools/exp_cond_knockout.py:134-142)
VARIANTS = {
    "no tocg (stub)": dict(use_tocg=False),
    "no blur-chain (nearest, no gauss)": dict(use_blur=False),
    "no warp (scaled copy)": dict(use_warp=False),
    "no downsamples (strided)": dict(use_down=False),
    "no argmax (sum proxy)": dict(use_argmax=False),
    "no LUT+onehot (slice proxy)": dict(use_onehot=False),
    "no parse path at all": dict(use_argmax=False, use_onehot=False),
}


def condition(tocg, b, cfg, *, use_tocg=True, use_blur=True, use_warp=True,
              use_down=True, use_argmax=True, use_onehot=True):
    """The condition stage with each piece switchable (the JAX tool's
    ``cond``); returns (warped cloth and mask (B, H, W, 4), parse7): with
    every piece on, ``condition_forward``'s without occlusion. (The JAX tool
    reduces them to one mean so that XLA keeps the work; a recorded graph
    drops nothing.)"""
    ch, cw, fh, fw = cfg.cond_height, cfg.cond_width, cfg.fine_height, cfg.fine_width
    cloth = b["cloth"]
    cm = (b["cloth_mask"] > 0.5).to(cloth.dtype)
    if use_down:
        cloth_d = interpolate(cloth, size=(ch, cw), mode="bilinear")
        cm_d = interpolate(cm, size=(ch, cw), mode="nearest")
        pa_d = interpolate(b["parse_agnostic"], size=(ch, cw), mode="nearest")
        dp_d = interpolate(b["densepose"], size=(ch, cw), mode="bilinear")
    else:
        sh, sw = fh // ch, fw // cw
        cloth_d, cm_d = cloth[:, ::sh, ::sw], cm[:, ::sh, ::sw]
        pa_d = b["parse_agnostic"][:, ::sh, ::sw]
        dp_d = b["densepose"][:, ::sh, ::sw]
    i1 = torch.cat([cloth_d, cm_d], -1)
    i2 = torch.cat([pa_d, dp_d], -1)
    if use_tocg:
        flow_list, seg, _, wcm = tocg(i1, i2)
    else:                                   # a stub of the same shapes
        seg = i2[..., :13] * 0.1
        wcm = i1[..., 3:4]
        flow_list = [torch.stack([i1[:, ::2 ** (4 - j), ::2 ** (4 - j), 0],
                                  i1[:, ::2 ** (4 - j), ::2 ** (4 - j), 1]],
                                 -1) * 3 for j in range(5)]
    seg = compose_clothmask(seg, wcm, cfg.clothmask_composition)
    if use_blur:
        fpg = gaussian_blur(interpolate(seg, size=(fh, fw), mode="bilinear"),
                            (15, 15), (3.0, 3.0))
    else:
        fpg = interpolate(seg, size=(fh, fw), mode="nearest")
    if use_argmax:
        fake_parse = torch.argmax(fpg, dim=-1)
    else:                                   # an elementwise proxy, fpg live
        fake_parse = (fpg.sum(-1) > 0).long()
    if use_onehot:
        parse7 = onehot(lut_lookup(fake_parse, group_index_of_label13()), 7,
                        dtype=cloth.dtype)
    else:                                   # no lookup, no one-hot
        parse7 = fpg[..., :7] + fake_parse[..., None].to(cloth.dtype)
    if use_warp:
        flow_full = resize_flow(flow_list[-1], (fh, fw), mode="bilinear")
        warped = flow_warp(torch.cat([cloth, cm], -1), flow_full,
                           cfg.flow_norm_w, cfg.flow_norm_h)
    else:
        warped = torch.cat([cloth, cm], -1) * 0.5
    return warped, parse7


_condition = graphs.captured(
    condition, weights=lambda tocg, *a, **k: graphs.module_tensors(tocg))


def full_equals_production(tocg, batch, cfg) -> None:
    """The full stage (replayed on the card) against ``condition_forward``
    on the same batch: the warped cloth and mask and parse7 bit for bit;
    raises if one differs (or where ``cfg.occlusion`` changes the warped
    cloth, which the JAX tool's stage leaves out)."""
    if cfg.occlusion:
        raise ValueError("the condition knockout has no occlusion step")
    warped, parse7 = _condition(tocg, batch, cfg)
    c = condition_forward(tocg, batch, cfg)
    want = torch.cat([c.warped_cloth, c.warped_clothmask], -1)
    if not (torch.equal(warped, want) and torch.equal(parse7, c.parse7)):
        raise RuntimeError("the condition knockout's full stage is not "
                           "condition_forward")


def main(device="cuda"):
    """Hold the full stage against ``condition_forward``, then time it and
    its seven variants, each replayed; returns the times (``in_pairs``)."""
    dev = resolve_device(device)
    size = knock_size()
    pipe = first_path_pipeline(size, dev)
    batch = synthetic_batch(size, dev)
    del batch["agnostic"]
    with torch.inference_mode():
        full_equals_production(pipe.tocg, batch, pipe.cfg)
        print("condition: the full stage equals condition_forward bit for bit "
              "(warped cloth and mask, parse7)", flush=True)

        def run(**kw):
            return _condition(pipe.tocg, batch, pipe.cfg, **kw)
        times = in_pairs(run, {n: (lambda kw=kw: run(**kw))
                               for n, kw in VARIANTS.items()}, size.pairs, dev)
    report(f"condition b{size.batch} {size.fh}x{size.fw}", times, card_name(dev))
    return times


if __name__ == "__main__":
    main()
