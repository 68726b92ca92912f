"""Fused {SPADE-norm -> activation -> consumer conv} unit.

PyTorch counterpart of ``hrviton_tpu/ops/spade_block.py``. One call fuses one
of a SPADEResBlock's three {SPADENorm, conv} pairs:

    mu, rsig   = instance stats of x + noise*nscale   # norm_stats, f32
    actv       = conv_shared(seg)                     # caller, pre-relu
    ------------------------------------------------------------- in-kernel:
    xn         = x + noise * nscale
    normalized = (xn - mu) * rsig
    mod        = normalized * (1 + conv_g(relu(actv))) + conv_b(relu(actv))
    out        = conv(act(mod), Wc) + bias [+ residual]

The kernel runs for bf16 on the card, and the plain version
``spade_conv_ref`` runs everywhere else (``_build.runs_kernel``). The
kernels are CUDA C++ for sm_90a (``csrc/spade_block.cu``), built with
``nvcc`` at first use into ``build/`` at the repository root and loaded with
ctypes (``ops/_build.py``): two launches on the TMA / wgmma conv engine, (a)
gamma|beta with the modulation in its epilogue, storing act(mod) (plain
version ``gamma_beta_stage_ref``), then (b) the consumer conv with the bias
and the residual (``consumer_stage_ref``); their weights are packed once
per weight tensor (``ops/conv_engine.py``). The statistics come from
``spade_fused.norm_stats`` (a one-pass kernel on the card). The gradient is
autograd of ``spade_conv_ref`` on the saved inputs, the meaning of the JAX
custom VJP.

Layouts: activations NHWC (contiguous), weights OIHW (the port's module
layout). ``noise`` is (B, H, W, 1) float32, as the JAX package draws it.

Knocks (timing only; the JAX ``fused_spade_conv(..., _knock=)``): the
``knock`` tags of ``spade_conv_unit`` each stub one stage of the unit, with
the JAX kernel's semantics (``UNIT_KNOCKS``), so that the time a tool
measures without it is the stage's. The empty set is the production unit;
no CLI reaches a knock and a knocked result is never an image. Where the
kernel runs, the knocked stages are variants of its two kernels compiled
with a knock mask (``csrc/spade_knock.cu``; ``stats`` is the wrapper's:
constant statistics, no ``norm_stats``); elsewhere the plain version takes
the knock. A knocked call has no gradient and counts each kernel it
launches: a variant in its counter (``knock_counters``), a stage it leaves
unknocked in ``knock_production``; never in the unit's.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from hrviton_tpu_torch.core import graphs, precision
from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.ops._build import ACT_CODES as _ACTS
from hrviton_tpu_torch.ops._build import check_tensor as _check
from hrviton_tpu_torch.ops._build import ref_grads
from hrviton_tpu_torch.ops.conv3x3 import activation
from hrviton_tpu_torch.ops.conv_engine import pack_kmajor, packed
from hrviton_tpu_torch.ops.spade_fused import _EPS
from hrviton_tpu_torch.ops.spade_fused import (gb_tiles, gb_weights,
                                               modulate_ref, norm_stats,
                                               pack_gb)

__all__ = ["spade_conv_unit", "spade_conv_ref", "gamma_beta_stage_ref",
           "consumer_stage_ref", "gb_tiles", "conv_tiles", "pack_gb",
           "fused_spade_conv_eligible", "UNIT_KNOCKS", "GENERATOR_KNOCKS", "KNOCK_SETS", "knock_counters",
           "knock_production", "knock_tags"]

_MIN_H = 256          # the JAX gate's row floor: admits up_3 and up_4 only
_CONV_BN = (32, 64, 128)    # the N tiles stage (b) is built for

# The unit's knock tags (the JAX kernel's `knock`, hrviton_tpu/ops/
# spade_block.py:105, and fused_spade_conv's `stats`, :298): what the unit
# computes instead
UNIT_KNOCKS = (
    "stats",        # mu = 0, rsig = 1; norm_stats is not launched
    "actv_dma",     # actv never read: the output is undefined (shape only)
    "prod_dots",    # gamma|beta = the biases alone, no products
    "prod_rolls",   # gamma|beta products summed over kx at the same column
    "normalize",    # normalized = xn
    "modulate",     # mod = normalized + gamma
    "cons_dots",    # 3x3 only: acc = act(mod)[..., :cout] in f32
    "cons_rolls",   # 3x3 only: consumer products summed over kx, no shift
)
# the generator's own tags (models/spade.py:gen_knock), which reach the unit
# forwarded with the rest and change nothing here, as in the JAX kernel
GENERATOR_KNOCKS = ("conv_shared", "seg_for", "unit", "features", "pyramid",
                    "conv_img")
# the tag sets the JAX tool times (tools/exp_block_knockout.py:33-43), the
# only in-kernel sets with kernel variants on the card
KNOCK_SETS = (("actv_dma",), ("prod_dots",), ("prod_rolls",), ("normalize",),
              ("modulate",), ("cons_dots",), ("cons_rolls",),
              ("prod_rolls", "cons_rolls"))
# each kernel's knock mask bits (csrc/conv_engine.cuh: KNOCK_NO_A,
# KNOCK_NO_DOTS, KNOCK_NO_ROLLS; csrc/spade_mod.cuh: KNOCK_NORMALIZE,
# KNOCK_MODULATE); only single-bit masks are instantiated
_GB_BITS = {"actv_dma": 1, "prod_dots": 2, "prod_rolls": 4, "normalize": 8,
            "modulate": 16}
_CONV_BITS = {"cons_dots": 2, "cons_rolls": 4}


# the launches of each knock variant of a kernel: "gb/<tag>": stage (a)'s
# variant, "conv/<tag>": stage (b)'s
knock_counters = {f"{stage}/{tag}": graphs.Count()
                  for stage, bits in (("gb", _GB_BITS), ("conv", _CONV_BITS))
                  for tag in bits}
# "gb" / "conv": a stage's production kernel (mask 0) launched by a knocked
# call, which knocks only the other stage (or only the statistics)
knock_production = {stage: graphs.Count() for stage in ("gb", "conv")}
graphs.register_counters(*knock_counters.values(), *knock_production.values())


def knock_tags(tags) -> frozenset:
    """``tags`` as a set; a tag that is neither the unit's nor the
    generator's raises."""
    tags = frozenset(tags)
    unknown = tags - set(UNIT_KNOCKS) - set(GENERATOR_KNOCKS)
    if unknown:
        raise ValueError(f"unknown knock tags {sorted(unknown)}; known: "
                         f"{UNIT_KNOCKS + GENERATOR_KNOCKS}")
    return tags


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.spade_unit_gb_forward_bf16.argtypes = [vp] * 9 + [i] * 8 + [vp]
    lib.spade_unit_gb_forward_bf16.restype = ctypes.c_int
    lib.spade_unit_conv_forward_bf16.argtypes = [vp] * 5 + [i] * 8 + [vp]
    lib.spade_unit_conv_forward_bf16.restype = ctypes.c_int


def _declare_knock(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.spade_unit_gb_knock_forward_bf16.argtypes = [vp] * 9 + [i] * 9 + [vp]
    lib.spade_unit_gb_knock_forward_bf16.restype = ctypes.c_int
    lib.spade_unit_conv_knock_forward_bf16.argtypes = [vp] * 5 + [i] * 9 + [vp]
    lib.spade_unit_conv_knock_forward_bf16.restype = ctypes.c_int


def fused_spade_conv_eligible(h: int, w: int, nh: int, dtype,
                              device) -> bool:
    """Shape gate: where the kernel runs (``_build.runs_kernel``: bf16 on
    the card), the JAX gate's shape rules (h % 8 == 0, w % 128 == 0, nh %
    128 == 0, h >= 256), which admit up_3 and up_4 at 1024x768 and nothing
    else. Elsewhere false: the unfused plain path runs."""
    return (_build.runs_kernel(dtype, device) and h % 8 == 0
            and w % 128 == 0 and nh % 128 == 0 and h >= _MIN_H)


def spade_conv_ref(x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                   pre_act=None, residual=None, knock=()):
    """Plain PyTorch formulation of the unit (the CPU path and the gold).

    x: (B, H, W, C); noise: (B, H, W, 1) f32; nscale: (C,); actv: (B, H, W,
    NH) pre-relu; wg/wb: (C, NH, 3, 3); bg/bb: (C,); wc: (cout, C, k, k);
    bc: (cout,) or None; residual: (B, H, W, cout) or None. NHWC out.
    ``knock``: the unit's tags (``UNIT_KNOCKS``), timing only.
    """
    knock = knock_tags(knock) & set(UNIT_KNOCKS)
    if not knock:
        mod = activation(modulate_ref(x, noise, nscale, actv, wg, bg, wb,
                                      bb), pre_act)
        return consumer_stage_ref(mod, wc, bc, residual)
    mu, rsig = (_no_stats(x) if "stats" in knock
                else _ref_stats(x, noise, nscale))
    mod = gamma_beta_stage_ref(x, noise, nscale, mu, rsig, actv, wg, bg, wb,
                               bb, pre_act, knock)
    return consumer_stage_ref(mod, wc, bc, residual, knock)


def _no_stats(x):
    """The knock ``stats``'s statistics: mu = 0, rsig = 1, (B, C) f32."""
    shape = (x.shape[0], x.shape[-1])
    return (torch.zeros(shape, dtype=torch.float32, device=x.device),
            torch.ones(shape, dtype=torch.float32, device=x.device))


def _ref_stats(x, noise, nscale):
    """mu, rsig (B, C) f32 as ``modulate_ref`` forms them (the JAX
    ``_stats``): the mean, then the mean square deviation."""
    xnf = (x + (noise * nscale).to(x.dtype)).float()
    mu = xnf.mean(dim=(1, 2), keepdim=True)
    var = (xnf - mu).square().mean(dim=(1, 2), keepdim=True)
    return mu[:, 0, 0], torch.rsqrt(var + _EPS)[:, 0, 0]


def _conv_no_rolls(a, w, dtype, padding):
    """The products of each kx summed at the same column (the knocks
    ``prod_rolls`` / ``cons_rolls``): a (3 x 1) conv with the weights summed
    over kx in f32, accumulated in f32 and rounded once to ``dtype``."""
    with precision.exact(torch.float32):
        y = F.conv2d(a.float(), w.float().sum(-1, keepdim=True),
                     padding=(padding, 0))
    return y.to(dtype)


def gamma_beta_stage_ref(x, noise, nscale, mu, rsig, actv, wg, bg, wb, bb,
                         pre_act=None, knock=()):
    """Plain version of the bf16 unit's first launch: act(mod), in x's
    dtype, from the statistics mu, rsig (B, C) f32. Each intermediate is
    rounded where ``modulate_ref`` rounds it, so with the statistics that
    ``modulate_ref`` forms itself this stage and ``consumer_stage_ref`` give
    ``spade_conv_ref`` bit for bit. ``knock``: ``actv_dma`` (actv read as
    zeros: the kernel's output is undefined), ``prod_dots``,
    ``prod_rolls``, ``normalize``, ``modulate`` as ``UNIT_KNOCKS`` says."""
    dtype = x.dtype
    xn = x + (noise * nscale).to(dtype)
    if "normalize" in knock:
        normalized = xn
    else:
        normalized = ((xn.float() - mu[:, None, None, :])
                      * rsig[:, None, None, :]).to(dtype)
    if "actv_dma" in knock:
        actv = torch.zeros_like(actv)
    a = F.relu(actv).permute(0, 3, 1, 2)
    if "prod_dots" in knock:
        gamma, beta = bg.to(dtype), bb.to(dtype)
    elif "prod_rolls" in knock:
        gamma = _conv_no_rolls(a, wg, dtype, 1).permute(0, 2, 3, 1) \
            + bg.to(dtype)
        beta = _conv_no_rolls(a, wb, dtype, 1).permute(0, 2, 3, 1) \
            + bb.to(dtype)
    else:
        with precision.exact(dtype):
            gamma = F.conv2d(a, wg.to(dtype), padding=1).permute(0, 2, 3, 1) \
                + bg.to(dtype)
            beta = F.conv2d(a, wb.to(dtype), padding=1).permute(0, 2, 3, 1) \
                + bb.to(dtype)
    if "modulate" in knock:
        return activation(normalized + gamma, pre_act)
    return activation(normalized * (1.0 + gamma) + beta, pre_act)


def consumer_stage_ref(mod, wc, bc=None, residual=None, knock=()):
    """Plain version of the unit's consumer: conv(mod, wc) (3x3 pad 1 or
    1x1) rounded to mod's dtype, + bc in that dtype, + residual. ``knock``
    (3x3 only, as in the JAX kernel): ``cons_dots`` takes mod's first cout
    channels for the conv, ``cons_rolls`` sums the products over kx at the
    same column."""
    pad = wc.shape[-1] // 2
    if pad and "cons_dots" in knock:
        cout, c = wc.shape[0], mod.shape[-1]
        if cout > c:
            raise ValueError(f"cons_dots takes cout <= C, got {cout} > {c}")
        y = mod[..., :cout]
    elif pad and "cons_rolls" in knock:
        y = _conv_no_rolls(mod.permute(0, 3, 1, 2), wc, mod.dtype,
                           pad).permute(0, 2, 3, 1)
    else:
        with precision.exact(mod.dtype):
            y = F.conv2d(mod.permute(0, 3, 1, 2), wc.to(mod.dtype),
                         padding=pad).permute(0, 2, 3, 1)
    if bc is not None:
        y = y + bc.to(y.dtype)
    if residual is not None:
        y = y + residual
    return y


def conv_tiles(cout: int):
    """(BN, NTILES) of stage (b): the narrowest of ``_CONV_BN`` that holds
    COUT, or tiles of 128."""
    bn = next((bn for bn in _CONV_BN if bn >= cout), _CONV_BN[-1])
    return bn, -(-cout // bn)


def _stage_weights(wg, bg, wb, bb, wc, bc, c: int, cout: int, ks: int):
    """The two stages' packed operands, each packed once per weight set:
    stage (a)'s ``spade_fused.gb_weights`` (wk_gb, bgb, CT, NTILES) and
    (wk_conv, bias (NTILES * BN) f32 rounded through bf16, BN, NTILES)."""
    bn, ntc = conv_tiles(cout)

    def make_conv():
        wk = pack_kmajor(wc.permute(2, 3, 1, 0).reshape(ks * ks, c, cout), bn)
        bias = torch.zeros(ntc * bn, dtype=torch.float32, device=wc.device)
        if bc is not None:
            bias[:cout] = bc.to(torch.bfloat16).float()
        return wk, bias
    conv = packed(f"spade_conv/{bn}", (wc, bc), make_conv)
    return gb_weights(wg, bg, wb, bb), (*conv, bn, ntc)


def _knock_masks(knock, ks: int):
    """(stage (a)'s mask, stage (b)'s) of a unit knock set; the consumer's
    tags are no-ops for a 1x1 conv, as in the JAX kernel. A set whose masks
    were not instantiated (more than one tag of a stage) raises."""
    gb = sum(_GB_BITS[t] for t in knock if t in _GB_BITS)
    conv = sum(_CONV_BITS[t] for t in knock if t in _CONV_BITS) if ks == 3 else 0
    if gb & (gb - 1) or conv & (conv - 1):
        raise NotImplementedError(
            f"knock {sorted(knock)}: the kernels have variants for one tag a "
            f"stage only (KNOCK_SETS)")
    return gb, conv


def _count_knocked(stage: str, mask: int) -> None:
    """One launch of a knocked call's kernel for ``stage``: its variant's,
    or the production kernel's where ``mask`` is 0."""
    if not mask:
        knock_production[stage].launches += 1
        return
    bits = _GB_BITS if stage == "gb" else _CONV_BITS
    tag = next(t for t, bit in bits.items() if bit == mask)
    knock_counters[f"{stage}/{tag}"].launches += 1


def _fused_cuda(pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                residual, knock=frozenset()):
    """The two launches of the unit on bf16 CUDA tensors (the kernel's
    route, ``_build.runs_kernel``)."""
    n, h, w, c = x.shape
    nh = actv.shape[-1]
    cout, ks = wc.shape[0], wc.shape[-1]
    if (ks not in (1, 3) or wc.shape[1] != c or tuple(wg.shape) != (c, nh, 3, 3)
            or c % 8 or cout % 8 or nh % 8):
        raise ValueError(f"unsupported unit shapes: x {tuple(x.shape)}, actv "
                         f"{tuple(actv.shape)}, wg {tuple(wg.shape)}, wc "
                         f"{tuple(wc.shape)} (C, COUT and NH multiples of 8)")
    dev = x.device
    _check("x", x, (n, h, w, c), torch.bfloat16, dev)
    _check("actv", actv, (n, h, w, nh), x.dtype, dev)
    noise = noise.reshape(n, h, w)
    _check("noise", noise, (n, h, w), torch.float32, dev)
    if residual is not None:
        _check("residual", residual, (n, h, w, cout), x.dtype, dev)
    if any(t.device != dev for t in (wg, wb, wc)):
        raise ValueError(f"unit weights must be on {dev}")
    lib = _build.load("spade_block", _declare)

    gb_mask, conv_mask = _knock_masks(knock, ks)
    mu, rsig = (_no_stats(x) if "stats" in knock
                else norm_stats(x, noise[..., None], nscale))
    nsc = nscale.float().contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = residual.data_ptr() if residual is not None else None
    (wk_gb, bgb, ct, ntg), (wk_c, bk, bn, ntc) = _stage_weights(
        wg, bg, wb, bb, wc, bc, c, cout, ks)
    mod = torch.empty_like(x)
    gb_args = (actv.data_ptr(), wk_gb.data_ptr(), x.data_ptr(),
               noise.data_ptr(), nsc.data_ptr(), mu.data_ptr(),
               rsig.data_ptr(), bgb.data_ptr(), mod.data_ptr(), n, h, w,
               nh, c, ct, ntg, _ACTS[pre_act])
    knocked = _build.load("spade_knock", _declare_knock) if knock else None
    if gb_mask:
        err = knocked.spade_unit_gb_knock_forward_bf16(*gb_args, gb_mask,
                                                      stream)
    else:
        err = lib.spade_unit_gb_forward_bf16(*gb_args, stream)
    if err == 0 and knock:
        _count_knocked("gb", gb_mask)
    conv_args = (mod.data_ptr(), wk_c.data_ptr(), bk.data_ptr(), res,
                 out.data_ptr(), n, h, w, c, cout, ks, bn, ntc)
    if err == 0 and conv_mask:
        err = knocked.spade_unit_conv_knock_forward_bf16(*conv_args,
                                                        conv_mask, stream)
    elif err == 0:
        err = lib.spade_unit_conv_forward_bf16(*conv_args, stream)
    if err == 0 and knock:
        _count_knocked("conv", conv_mask)
    if err != 0:
        raise RuntimeError(f"spade_unit launch failed: cudaError {err}")
    if not knock:
        spade_conv_unit.launches += 1
    return out


class _Unit(torch.autograd.Function):
    """The fused unit as a differentiable op (JAX ``spade_conv_unit``'s
    custom VJP, ``_unit_bwd``): the forward launches the kernels where
    they run (``_build.runs_kernel``) and is the plain version elsewhere, the
    backward is autograd of ``spade_conv_ref`` on the saved inputs; ``bc``
    and ``residual`` may be None."""

    @staticmethod
    def forward(ctx, pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                residual):
        if _build.wrapper_runs_kernel("spade_conv_unit", x):
            out = _fused_cuda(pre_act, x, noise, nscale, actv, wg, bg, wb, bb,
                              wc, bc, residual)
        else:
            out = spade_conv_ref(x, noise, nscale, actv, wg, bg, wb, bb, wc,
                                 bc, pre_act=pre_act, residual=residual)
        ctx.pre_act = pre_act
        ctx.save_for_backward(x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                              residual)
        return out

    @staticmethod
    def backward(ctx, g):
        pre_act = ctx.pre_act

        def plain(x, noise, nscale, actv, wg, bg, wb, bb, wc, bc, residual):
            return spade_conv_ref(x, noise, nscale, actv, wg, bg, wb, bb, wc,
                                  bc, pre_act=pre_act, residual=residual)
        return (None, *ref_grads(ctx.needs_input_grad[1:], g,
                                 ctx.saved_tensors, plain))


def spade_conv_unit(pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                    residual: Optional[torch.Tensor] = None, knock=()):
    """Fused unit (argument order of the JAX ``spade_conv_unit``).

    bf16 CUDA tensors launch the kernel (or raise); everything else takes
    the plain formulation. Differentiable (``_Unit``). ``spade_conv_unit.launches``
    counts kernel launches. ``knock``: timing-only tags (module docstring);
    the generator's pass through, an unknown one raises; a call with a
    unit tag is not differentiable.
    """
    if pre_act not in _ACTS:
        raise ValueError(pre_act)
    knock = knock_tags(knock) & set(UNIT_KNOCKS)
    if not knock:
        return _Unit.apply(pre_act, x, noise, nscale, actv, wg, bg, wb, bb,
                           wc, bc, residual)
    with torch.no_grad():
        if _build.wrapper_runs_kernel("spade_conv_unit", x):
            return _fused_cuda(pre_act, x, noise, nscale, actv, wg, bg, wb,
                               bb, wc, bc, residual, knock)
        return spade_conv_ref(x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                              pre_act=pre_act, residual=residual, knock=knock)


spade_conv_unit.launches = 0
graphs.register_counters(spade_conv_unit)   # counted in replays too

