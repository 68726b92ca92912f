#!/usr/bin/env python
"""In-kernel knockout attribution of the fused SPADE unit (timing only).

PyTorch counterpart of ``tools/exp_block_knockout.py``: each variant
removes one stage of the unit (``ops/spade_block.py``, ``knock=``; on the
card a knock variant of the unit's two kernels, ``csrc/spade_knock.cu``),
and the time it saves is that stage's. The eight tag sets are the JAX tool's
(``spade_block.KNOCK_SETS``); here they run at the six unit shapes of the
first path (up_3 and up_4, ``_knockout.unit_shapes``), batch 4, bf16, each in
pairs with the full unit, and the six units' sums are printed last.

    python -m hrviton_tpu_torch.tools.exp_block_knockout

Sizes from the KNOCK_* variables (``tools/_knockout.py``).
"""

from __future__ import annotations

import torch

from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.ops.spade_block import KNOCK_SETS, spade_conv_unit
from hrviton_tpu_torch.tools._knockout import (card_name, in_pairs, knock_size,
                                               randn, report, unit_shapes)

__all__ = ["unit_inputs", "main"]


def unit_inputs(rng, b, h, w, c, cout, ks, residual, dtype=torch.bfloat16):
    """The unit's arguments after ``pre_act``, drawn on ``rng``'s device
    (the JAX tool's scales): x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
    residual."""
    f32 = torch.float32
    return (randn(rng, (b, h, w, c), dtype), randn(rng, (b, h, w, 1), f32),
            randn(rng, (c,), f32, 0.1), randn(rng, (b, h, w, 128), dtype),
            randn(rng, (c, 128, 3, 3), dtype, 0.05), randn(rng, (c,), f32, 0.1),
            randn(rng, (c, 128, 3, 3), dtype, 0.05), randn(rng, (c,), f32, 0.1),
            randn(rng, (cout, c, ks, ks), dtype, 0.05),
            randn(rng, (cout,), f32, 0.1),
            randn(rng, (b, h, w, cout), dtype) if residual else None)


def main(device="cuda"):
    """Time the unit and its eight knock variants at the six unit shapes;
    returns {unit name or "six units": {variant: times}} (``in_pairs``)."""
    dev = resolve_device(device)
    size = knock_size()
    rng = torch.Generator(device=dev).manual_seed(0)
    card = card_name(dev)
    out, total = {}, {}
    with torch.no_grad():
        for name, h, w, c, cout, ks, pre_act, residual in unit_shapes(size):
            args = unit_inputs(rng, size.batch, h, w, c, cout, ks, residual)

            def call(knock=(), args=args, pre_act=pre_act):
                return spade_conv_unit(pre_act, *args[:10], args[10],
                                       knock=knock)
            variants = {"+".join(k): (lambda k=k: call(k)) for k in KNOCK_SETS}
            times = in_pairs(call, variants, size.pairs, dev)
            report(f"{name} {c}->{cout} k{ks} @{h}x{w} b{size.batch}", times,
                   card)
            out[name] = times
            for v, t in times.items():
                acc = total.setdefault(v, {"ms": 0.0, "full_ms": 0.0,
                                           "attributed_ms": 0.0})
                for k in acc:
                    acc[k] = None if t[k] is None or acc[k] is None else acc[k] + t[k]
    report("six units", total, card)
    out["six units"] = total
    return out


if __name__ == "__main__":
    main()
