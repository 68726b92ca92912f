"""unit_roofline (%): the fused SPADE unit (``ops/spade_block.spade_conv_unit``
with its statistics, ``csrc/spade_block.cu``) against its roofline: the
least time of the forward's units at the cell's shapes and batch (the larger
of operations over 989 TFLOP/s and bytes over 3.35 TB/s, counted from the
function's shapes by ``benchmark/flops.py``) over their time. The time is
taken after the window by CUDA events over ``REPS`` launches of each unit
alone (after ``WARM``), summed over the units. Nothing is read unless the
window's launch counter shows exactly the configuration's units a
forward."""

import torch

from benchmark.flops import bound_s, unit_bytes, unit_flops, unit_shapes

WARM, REPS = 3, 20


def probe(ctx, rec):
    if ctx.device != "cuda":
        return None
    from hrviton_tpu_torch.ops.spade_block import spade_conv_unit
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    b = ctx.traffic["batch"]
    out = []
    for u in unit_shapes(ctx.config):
        r = lambda *s, dtype=dt: torch.randn(s, generator=gen, device="cuda",
                                             dtype=dtype)
        args = (u.pre_act, r(b, u.h, u.w, u.c),
                r(b, u.h, u.w, 1, dtype=torch.float32), r(u.c),
                r(b, u.h, u.w, 128), r(u.c, 128, 3, 3) * 0.03, r(u.c),
                r(u.c, 128, 3, 3) * 0.03, r(u.c),
                r(u.cout, u.c, u.ks, u.ks) * 0.1,
                r(u.cout) if u.ks == 3 else None,
                r(b, u.h, u.w, u.cout) if u.residual else None)
        with torch.no_grad():
            for _ in range(WARM):
                spade_conv_unit(*args)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                spade_conv_unit(*args)
            e1.record()
            e1.synchronize()
        ms = e0.elapsed_time(e1) / REPS
        fl = unit_flops(b, u.h, u.w, u.c, u.cout, u.ks)
        nb = unit_bytes(b, u.h, u.w, u.c, u.cout, u.ks, residual=u.residual)
        out.append({"unit": u.name, "ms": ms, "bound_ms": 1e3 * bound_s(
            fl, nb, "bfloat16")})
        ctx.log(f"unit {u.name} batch {b}: {ms:.4f} ms, bound "
                f"{out[-1]['bound_ms']:.4f} ms")
        del args
    return out


def read(rec):
    units = (rec.get("probes") or {}).get("unit_roofline")
    if not units:
        return None
    per_forward = rec["launches"]["spade_conv_unit"] / max(rec["forwards"], 1)
    if per_forward != len(units):
        return None
    return 100.0 * sum(u["bound_ms"] for u in units) / sum(u["ms"] for u in units)
