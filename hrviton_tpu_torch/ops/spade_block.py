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

The kernels are CUDA C++ for sm_90a (``csrc/spade_block.cu``), built with
``nvcc`` at first use into ``build/`` at the repository root and loaded with
ctypes (``ops/_build.py``). bf16 runs in two launches on the TMA / wgmma conv
engine: (a) gamma|beta with the modulation in its epilogue, storing act(mod)
(plain version ``gamma_beta_stage_ref``), then (b) the consumer conv with
the bias and the residual (``consumer_stage_ref``); their weights are packed
once per weight tensor (``ops/conv_engine.py``). f32 runs one fused kernel
on plain FMA loops; no path reaches it, since the gate takes bf16 only, as
the JAX gate does: it serves direct calls. The statistics come from ``spade_fused.norm_stats`` (a
one-pass kernel on the card). ``spade_conv_unit`` launches the kernels for
CUDA tensors and takes the plain formulation ``spade_conv_ref`` only for CPU
tensors; a CUDA tensor never reaches the plain version through its forward.
Its gradient is autograd of ``spade_conv_ref`` on the saved inputs, the
meaning of the JAX custom VJP.

Layouts: activations NHWC (contiguous), weights OIHW (the port's module
layout). ``noise`` is (B, H, W, 1) float32, as the JAX package draws it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from hrviton_tpu_torch.core import graphs, precision
from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.ops._build import ACT_CODES as _ACTS
from hrviton_tpu_torch.ops._build import KERNEL_DTYPES as _DTYPES
from hrviton_tpu_torch.ops._build import check_tensor as _check
from hrviton_tpu_torch.ops._build import pad_to as _pad_to
from hrviton_tpu_torch.ops._build import ref_grads
from hrviton_tpu_torch.ops.conv3x3 import activation
from hrviton_tpu_torch.ops.conv_engine import pack_kmajor, packed
from hrviton_tpu_torch.ops.spade_fused import (gb_tiles, gb_weights,
                                               modulate_ref, norm_stats,
                                               pack_gb)

__all__ = ["spade_conv_unit", "spade_conv_ref", "gamma_beta_stage_ref",
           "consumer_stage_ref", "gb_tiles", "conv_tiles", "pack_gb",
           "fused_spade_conv_eligible", "unit_flops", "unit_bytes"]

_MIN_H = 256          # the JAX gate's row floor: admits up_3 and up_4 only
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_CONV_BN = (32, 64, 128)    # the N tiles stage (b) is built for


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.spade_unit_forward.argtypes = [vp] * 12 + [i] * 10 + [vp]
    lib.spade_unit_forward.restype = ctypes.c_int
    lib.spade_unit_smem_bytes.argtypes = [i, i, i]
    lib.spade_unit_smem_bytes.restype = ctypes.c_size_t
    lib.spade_unit_gb_forward_bf16.argtypes = [vp] * 9 + [i] * 8 + [vp]
    lib.spade_unit_gb_forward_bf16.restype = ctypes.c_int
    lib.spade_unit_conv_forward_bf16.argtypes = [vp] * 5 + [i] * 8 + [vp]
    lib.spade_unit_conv_forward_bf16.restype = ctypes.c_int


def fused_spade_conv_eligible(h: int, w: int, nh: int, dtype,
                              device) -> bool:
    """Shape gate: the JAX gate's shape rules (h % 8 == 0, w % 128 == 0,
    nh % 128 == 0, h >= 256), which admit up_3 and up_4 at 1024x768 and
    nothing else, on a CUDA device, in bfloat16 only, as the JAX gate takes
    bf16 only: an f32 forward runs the unfused plain path, and the f32
    kernel is reached by a direct call of ``spade_conv_unit`` alone. Always
    false on the CPU, where the unfused plain path runs."""
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and h % 8 == 0 and w % 128 == 0 and nh % 128 == 0
            and h >= _MIN_H)


def spade_conv_ref(x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                   pre_act=None, residual=None):
    """Plain PyTorch formulation of the unit (the CPU path and the gold).

    x: (B, H, W, C); noise: (B, H, W, 1) f32; nscale: (C,); actv: (B, H, W,
    NH) pre-relu; wg/wb: (C, NH, 3, 3); bg/bb: (C,); wc: (cout, C, k, k);
    bc: (cout,) or None; residual: (B, H, W, cout) or None. NHWC out.
    """
    mod = activation(modulate_ref(x, noise, nscale, actv, wg, bg, wb, bb),
                     pre_act)
    return consumer_stage_ref(mod, wc, bc, residual)


def gamma_beta_stage_ref(x, noise, nscale, mu, rsig, actv, wg, bg, wb, bb,
                         pre_act=None):
    """Plain version of the bf16 unit's first launch: act(mod), in x's
    dtype, from the statistics mu, rsig (B, C) f32. Each intermediate is
    rounded where ``modulate_ref`` rounds it, so with the statistics that
    ``modulate_ref`` forms itself this stage and ``consumer_stage_ref`` give
    ``spade_conv_ref`` bit for bit."""
    dtype = x.dtype
    xn = x + (noise * nscale).to(dtype)
    normalized = ((xn.float() - mu[:, None, None, :])
                  * rsig[:, None, None, :]).to(dtype)
    a = F.relu(actv).permute(0, 3, 1, 2)
    with precision.exact(dtype):
        gamma = F.conv2d(a, wg.to(dtype), padding=1).permute(0, 2, 3, 1) \
            + bg.to(dtype)
        beta = F.conv2d(a, wb.to(dtype), padding=1).permute(0, 2, 3, 1) \
            + bb.to(dtype)
    return activation(normalized * (1.0 + gamma) + beta, pre_act)


def consumer_stage_ref(mod, wc, bc=None, residual=None):
    """Plain version of the unit's consumer: conv(mod, wc) (3x3 pad 1 or
    1x1) rounded to mod's dtype, + bc in that dtype, + residual."""
    pad = wc.shape[-1] // 2
    with precision.exact(mod.dtype):
        y = F.conv2d(mod.permute(0, 3, 1, 2), wc.to(mod.dtype),
                     padding=pad).permute(0, 2, 3, 1)
    if bc is not None:
        y = y + bc.to(y.dtype)
    if residual is not None:
        y = y + residual
    return y


def _pack_weights(wg, bg, wb, bb, wc, bc):
    """float32 kernel layouts: wgb (9, NH/4, CP, 8) [gamma k0..3 | beta
    k0..3]; bgb (2, CP); wck (k*k, C, COUTP); bck (COUTP,). Zero padding on
    the channel axes (CP, COUTP: multiples of 32)."""
    c, nh = wg.shape[0], wg.shape[1]
    cout, ks = wc.shape[0], wc.shape[-1]
    cp, coutp = _pad_to(c, 32), _pad_to(cout, 32)

    def quads(w):   # (C, NH, 3, 3) -> (9, NH/4, C, 4)
        return w.permute(2, 3, 1, 0).reshape(9, nh // 4, 4, c).permute(0, 1, 3, 2)

    f32 = torch.float32
    wgb = torch.cat([quads(wg), quads(wb)], dim=-1).to(f32)
    wgb = F.pad(wgb, (0, 0, 0, cp - c)).contiguous()
    bgb = F.pad(torch.stack([bg, bb]).to(f32), (0, cp - c)).contiguous()
    wck = wc.permute(2, 3, 1, 0).reshape(ks * ks, c, cout).to(f32)
    wck = F.pad(wck, (0, coutp - cout)).contiguous()
    if bc is None:
        bck = torch.zeros(coutp, dtype=f32, device=wc.device)
    else:
        bck = F.pad(bc.to(f32), (0, coutp - cout)).contiguous()
    return wgb, bgb, wck, bck, cp, coutp


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


def _fused_cuda(pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                residual):
    if x.dtype not in _DTYPES:
        raise TypeError(f"spade_conv_unit kernel takes float32/bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    nh = actv.shape[-1]
    cout, ks = wc.shape[0], wc.shape[-1]
    if nh % 4 or ks not in (1, 3) or wc.shape[1] != c or tuple(wg.shape) != (c, nh, 3, 3):
        raise ValueError(f"unsupported unit shapes: x {tuple(x.shape)}, actv "
                         f"{tuple(actv.shape)}, wg {tuple(wg.shape)}, wc {tuple(wc.shape)}")
    dev = x.device
    _check("x", x, (n, h, w, c), x.dtype, dev)
    _check("actv", actv, (n, h, w, nh), x.dtype, dev)
    noise = noise.reshape(n, h, w)
    _check("noise", noise, (n, h, w), torch.float32, dev)
    if residual is not None:
        _check("residual", residual, (n, h, w, cout), x.dtype, dev)
    if any(t.device != dev for t in (wg, wb, wc)):
        raise ValueError(f"unit weights must be on {dev}")
    lib = _build.load("spade_block", _declare)
    tc = x.dtype == torch.bfloat16
    if tc:
        if c % 8 or cout % 8 or nh % 8:
            raise ValueError(f"unsupported unit: c={c} cout={cout} nh={nh} k={ks} "
                             f"{x.dtype} (bf16 takes multiples of 8)")
    else:
        smem = lib.spade_unit_smem_bytes(ks, nh, c)
        if smem == 0 or smem > _SMEM_LIMIT:
            raise ValueError(f"unsupported unit: c={c} cout={cout} nh={nh} k={ks} "
                             f"{x.dtype} ({smem} B of shared memory)")

    mu, rsig = norm_stats(x, noise[..., None], nscale)
    nsc = nscale.float().contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = residual.data_ptr() if residual is not None else None
    if tc:
        (wk_gb, bgb, ct, ntg), (wk_c, bk, bn, ntc) = _stage_weights(
            wg, bg, wb, bb, wc, bc, c, cout, ks)
        mod = torch.empty_like(x)
        err = lib.spade_unit_gb_forward_bf16(
            actv.data_ptr(), wk_gb.data_ptr(), x.data_ptr(), noise.data_ptr(),
            nsc.data_ptr(), mu.data_ptr(), rsig.data_ptr(), bgb.data_ptr(),
            mod.data_ptr(), n, h, w, nh, c, ct, ntg, _ACTS[pre_act], stream)
        if err == 0:
            err = lib.spade_unit_conv_forward_bf16(
                mod.data_ptr(), wk_c.data_ptr(), bk.data_ptr(), res,
                out.data_ptr(), n, h, w, c, cout, ks, bn, ntc, stream)
    else:
        wgb, bgb, wck, bck, cp, coutp = _pack_weights(wg, bg, wb, bb, wc, bc)
        err = lib.spade_unit_forward(
            x.data_ptr(), noise.data_ptr(), nsc.data_ptr(), mu.data_ptr(),
            rsig.data_ptr(), actv.data_ptr(), wgb.data_ptr(), bgb.data_ptr(),
            wck.data_ptr(), bck.data_ptr(), res, out.data_ptr(),
            n, h, w, c, nh, cout, cp, coutp, ks, _ACTS[pre_act], stream)
    if err != 0:
        raise RuntimeError(f"spade_unit launch failed: cudaError {err}")
    spade_conv_unit.launches += 1
    return out


class _Unit(torch.autograd.Function):
    """The fused unit as a differentiable op (JAX ``spade_conv_unit``'s
    custom VJP, ``_unit_bwd``): the forward launches the kernels (the plain
    version on the CPU), the backward is autograd of ``spade_conv_ref`` on
    the saved inputs; ``bc`` and ``residual`` may be None."""

    @staticmethod
    def forward(ctx, pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                residual):
        if x.device.type == "cpu":
            out = spade_conv_ref(x, noise, nscale, actv, wg, bg, wb, bb, wc,
                                 bc, pre_act=pre_act, residual=residual)
        elif x.device.type != "cuda":
            raise ValueError(f"spade_conv_unit: unsupported device {x.device}")
        else:
            out = _fused_cuda(pre_act, x, noise, nscale, actv, wg, bg, wb, bb,
                              wc, bc, residual)
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
                    residual: Optional[torch.Tensor] = None):
    """Fused unit (argument order of the JAX ``spade_conv_unit``).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    formulation. Differentiable (``_Unit``). ``spade_conv_unit.launches``
    counts kernel launches.
    """
    if pre_act not in _ACTS:
        raise ValueError(pre_act)
    return _Unit.apply(pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc,
                       bc, residual)


spade_conv_unit.launches = 0
graphs.register_counters(spade_conv_unit)   # counted in replays too


def unit_flops(b, h, w, c, cout, ks, nh=128) -> int:
    """Operations the unit needs (2 per multiply-add): gamma and beta 3x3
    convs over nh channels plus the consumer conv. Elementwise work is
    negligible beside them and is not counted."""
    return 2 * b * h * w * (2 * 9 * nh * c + ks * ks * c * cout)


def unit_bytes(b, h, w, c, cout, ks, nh=128, elem=2, residual=False) -> int:
    """Bytes the unit must move: x, actv, noise (f32), residual read once,
    out written once, weights read once."""
    px = b * h * w
    act = px * (c + nh + cout * (2 if residual else 1)) * elem + px * 4
    weights = (2 * 9 * nh * c + ks * ks * c * cout) * elem
    return act + weights
