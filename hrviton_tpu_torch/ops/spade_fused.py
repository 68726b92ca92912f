"""Fused SPADE-norm modulation chain.

PyTorch counterpart of ``hrviton_tpu/ops/spade_fused.py``. One call computes
a SPADENorm from the pre-relu ``actv = conv_shared(seg)`` on:

    mu, rsig   = instance stats of x + noise*nscale   # norm_stats, f32
    ------------------------------------------------------------- in-kernel:
    xn         = x + noise * nscale
    normalized = (xn - mu) * rsig
    out        = normalized * (1 + conv_g(relu(actv))) + conv_b(relu(actv))

The kernel runs for bf16 on the card, and the plain version ``modulate_ref``
runs everywhere else (``_build.runs_kernel``). The kernel is CUDA C++ for
sm_90a (``csrc/spade_fused.cu``) on the TMA / wgmma conv engine
(``csrc/conv_engine.cuh``), as the fused unit's gamma|beta stage, with the
modulation in the epilogue (``csrc/spade_mod.cuh``) and its weights packed
once per weight tensor (``gb_weights``, shared with ``ops/spade_block.py``).
gamma, beta and ``normalized`` never reach device memory. Its gradient is
autograd of the plain version on the saved inputs, as the JAX custom VJP's
backward is XLA autodiff of its reference. The instance statistics are a
pass of their own, as in the JAX package: ``norm_stats``, a one-pass CUDA
kernel under the same rule (also the fused unit's) whose plain version is
``instance_stats``.

Layouts: activations NHWC (contiguous), weights OIHW (the port's module
layout). ``noise`` is (B, H, W, 1) float32, as the JAX package draws it.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from hrviton_tpu_torch.core import graphs, precision
from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.ops._build import check_tensor, pad_to, ref_grads
from hrviton_tpu_torch.ops.conv_engine import pack_kmajor, packed

__all__ = ["fused_spade_modulate", "modulate_ref", "fused_spade_eligible",
           "enable_fast_spade", "fast_spade_enabled", "fast_spade",
           "instance_stats", "norm_stats", "gb_tiles", "pack_gb",
           "gb_weights", "modulate_launcher"]

_TH = 16         # the JAX kernel's rows per grid step: its gate's row rule
_GB_BN = (64, 80, 96)   # the N tiles of the gamma|beta stage (both kernels)
_ENABLED = False
_MIN_H = 256
_EPS = 1e-5


def enable_fast_spade(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def fast_spade_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def fast_spade(on: bool = True):
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    try:
        yield
    finally:
        _ENABLED = prev


def fused_spade_eligible(x_shape, nhidden: int, dtype, device) -> bool:
    """Gate of the kernel: ``fast_spade`` on, and the JAX gate's shape rules
    (h % 16 == 0, w % 8 == 0, h > 16, nhidden % 128 == 0, h >= 256, w >= 96)
    where the kernel runs (``_build.runs_kernel``: bf16 on the card). At
    1024x768 they admit the norms of up_2, up_3 and up_4."""
    if not _ENABLED:
        return False
    _, h, w, _ = x_shape
    if not (h % _TH == 0 and w % 8 == 0 and h > _TH):
        return False
    if nhidden % 128 != 0:
        return False
    return _build.runs_kernel(dtype, device) and h >= _MIN_H and w >= 96


def instance_stats(x, noise, nscale):
    """f32 per-(batch, channel) instance stats of x + noise*nscale (NHWC):
    mean and 1/sqrt(biased var + eps), in one var_mean pass."""
    xnf = (x + (noise * nscale).to(x.dtype)).float()
    var, mu = torch.var_mean(xnf, dim=(1, 2), correction=0)
    return mu, torch.rsqrt(var + _EPS)


def norm_stats(x, noise, nscale):
    """The instance statistics as ``instance_stats`` gives them: mu and
    1/sqrt(var + eps) of x + noise*nscale per (image, channel), f32 (B, C).

    x: (B, H, W, C); noise: (B, H, W, 1) f32; nscale: (C,). A bf16 CUDA x
    launches the one-pass kernel of ``csrc/spade_fused.cu`` (or raises): x
    is read once, xn formed in bf16 as the plain version forms it, summed
    per thread in f32 about a shift and merged in f64. Any other x takes
    ``instance_stats``. ``norm_stats.launches`` counts kernel launches."""
    if not _build.wrapper_runs_kernel("norm_stats", x):
        return instance_stats(x, noise, nscale)
    n, h, w, c = x.shape
    dev = x.device
    check_tensor("x", x, (n, h, w, c), torch.bfloat16, dev)
    noise = noise.reshape(n, h, w)
    check_tensor("noise", noise, (n, h, w), torch.float32, dev)
    if tuple(nscale.shape) != (c,) or c > 2048:
        raise ValueError(f"norm_stats: nscale {tuple(nscale.shape)} for C = {c} "
                         f"(at most 2048)")
    lib = _build.load("spade_fused", _declare)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = max(1, min(-(-4 * sms // n), -(-h * w // 1024)))
    ws = torch.empty((n, chunks, c, 2), dtype=torch.float64, device=dev)
    mu = torch.empty((n, c), dtype=torch.float32, device=dev)
    rsig = torch.empty_like(mu)
    err = lib.instance_stats_forward(
        x.data_ptr(), noise.data_ptr(), nscale.float().contiguous().data_ptr(),
        ws.data_ptr(), mu.data_ptr(), rsig.data_ptr(), n, h * w, c, chunks,
        _EPS, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_stats_forward launch failed: cudaError {err}")
    norm_stats.launches += 1
    return mu, rsig


norm_stats.launches = 0
graphs.register_counters(norm_stats)   # counted in replays too


def modulate_ref(x, noise, nscale, actv, wg, bg, wb, bb):
    """Plain PyTorch formulation (the route of everything but bf16 on the
    card, and the gold).

    x: (B, H, W, C); noise: (B, H, W, 1) f32; nscale: (C,); actv: (B, H, W,
    NH) pre-relu; wg/wb: (C, NH, 3, 3); bg/bb: (C,). NHWC out, x's dtype.
    """
    dtype = x.dtype
    xn = x + (noise * nscale).to(dtype)
    xnf = xn.float()
    mu = xnf.mean(dim=(1, 2), keepdim=True)
    var = (xnf - mu).square().mean(dim=(1, 2), keepdim=True)
    normalized = ((xnf - mu) * torch.rsqrt(var + _EPS)).to(dtype)
    a = F.relu(actv).permute(0, 3, 1, 2)
    with precision.exact(dtype):
        gamma = F.conv2d(a, wg.to(dtype), padding=1).permute(0, 2, 3, 1) \
            + bg.to(dtype)
        beta = F.conv2d(a, wb.to(dtype), padding=1).permute(0, 2, 3, 1) \
            + bb.to(dtype)
    return normalized * (1.0 + gamma) + beta


def gb_tiles(c: int):
    """(CT, NTILES) of the gamma|beta stage for C channels: the fewest N
    tiles of at most 96 columns (wider tiles hold more accumulators than the
    consumers' registers, and spill, PERF.md §6), each CT channels wide (2
    CT columns, the narrowest of ``_GB_BN`` that holds C / NTILES, zero
    columns past C): C = 144 is three tiles of 48, C = 80 two of 40, C =
    272 six of 48, C = 128 three of 48. Kept over the rule "fewest padded
    columns" (``_GB_BN = (64, 80)``: 272 seven tiles of 40, 128 four of 32,
    144 four of 40) because the nine norms of the second path take 9.26 ms
    with it against 9.69 (alone, batch 4 at 1024x768, NVIDIA H100 80GB HBM3
    at 700 W, ``chip_smoke.py --alone`` in turns, PERF.md §6), although at C
    = 128 four tiles of 32 are as fast or slightly faster (0.272 against
    0.272-0.286 ms)."""
    ntiles = -(-2 * c // _GB_BN[-1])
    need = 2 * pad_to(-(-c // ntiles), 8)
    return next(bn for bn in _GB_BN if bn >= need) // 2, ntiles


def pack_gb(wg, wb, ct: int, ntiles: int):
    """The gamma|beta stage's weights: the taps of gamma and beta, (9, NH, C)
    each, as one (9, NH, NTILES * 2 CT) operand whose N tile j holds, for i <
    CT / 8, gamma of the channels j CT + 8 i .. + 7 in columns 16 i .. + 7
    and beta of the same channels in columns 16 i + 8 .. + 15 (zeros past
    C); then ``pack_kmajor`` with N tiles of 2 CT."""
    c, nh = wg.shape[0], wg.shape[1]

    def taps(w):   # (C, NH, 3, 3) -> (9, NH, NTILES, CT / 8, 8), zero-padded
        t = F.pad(w.permute(2, 3, 1, 0).reshape(9, nh, c), (0, ntiles * ct - c))
        return t.reshape(9, nh, ntiles, ct // 8, 8)
    both = torch.stack([taps(wg), taps(wb)], dim=4)        # (..., CT / 8, 2, 8)
    return pack_kmajor(both.reshape(9, nh, ntiles * 2 * ct), 2 * ct)


def gb_weights(wg, bg, wb, bb):
    """The gamma|beta stage's operands, packed once per weight set: (wk,
    bgb (2, C) f32 rounded through bf16, CT, NTILES)."""
    ct, ntiles = gb_tiles(wg.shape[0])

    def make():
        return (pack_gb(wg, wb, ct, ntiles),
                torch.stack([bg, bb]).to(torch.bfloat16).float().contiguous())
    return (*packed(f"spade_gb/{ct}", (wg, wb, bg, bb), make), ct, ntiles)


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.spade_modulate_forward_bf16.argtypes = [vp] * 9 + [i] * 7 + [vp]
    lib.spade_modulate_forward_bf16.restype = ctypes.c_int
    lib.instance_stats_forward.argtypes = [vp] * 6 + [i] * 4 + [ctypes.c_float, vp]
    lib.instance_stats_forward.restype = ctypes.c_int


def modulate_launcher(x, noise, nscale, actv, wg, bg, wb, bb):
    """Check the arguments, compute the statistics, pack the weights and
    allocate the output; return (launch, out): ``launch()`` makes the one
    kernel launch into ``out`` and nothing else (so that the kernel can be
    timed alone), and raises if the launch fails. bf16 CUDA tensors only."""
    n, h, w, c = x.shape
    nh = actv.shape[-1]
    if (tuple(wg.shape) != (c, nh, 3, 3) or tuple(wb.shape) != (c, nh, 3, 3)
            or nh % 8 or c % 8):
        raise ValueError(f"unsupported modulate shapes: x {tuple(x.shape)}, actv "
                         f"{tuple(actv.shape)}, wg {tuple(wg.shape)}, wb "
                         f"{tuple(wb.shape)} (C and NH multiples of 8)")
    dev = x.device
    check_tensor("x", x, (n, h, w, c), torch.bfloat16, dev)
    check_tensor("actv", actv, (n, h, w, nh), x.dtype, dev)
    noise = noise.reshape(n, h, w)
    check_tensor("noise", noise, (n, h, w), torch.float32, dev)
    if any(t.device != dev for t in (wg, wb, nscale)):
        raise ValueError(f"modulate weights must be on {dev}")
    lib = _build.load("spade_fused", _declare)
    mu, rsig = norm_stats(x, noise[..., None], nscale)
    nsc = nscale.float().contiguous()
    out = torch.empty_like(x)
    wk, bgb, ct, ntiles = gb_weights(wg, bg, wb, bb)
    args = (actv.data_ptr(), wk.data_ptr(), x.data_ptr(), noise.data_ptr(),
            nsc.data_ptr(), mu.data_ptr(), rsig.data_ptr(), bgb.data_ptr(),
            out.data_ptr(), n, h, w, nh, c, ct, ntiles,
            torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = lib.spade_modulate_forward_bf16(*args)
        if err != 0:
            raise RuntimeError(f"spade_modulate_forward launch failed: cudaError {err}")
    launch.args = args                                  # the entry point's arguments
    launch.operands = (noise, mu, rsig, nsc, wk, bgb)   # alive while launch may run
    return launch, out


class _Modulate(torch.autograd.Function):
    """The kernel as a differentiable op (JAX ``fused_spade_modulate``'s
    custom VJP): the forward launches it where it runs
    (``_build.runs_kernel``) and is the plain version elsewhere, the
    backward is autograd of ``modulate_ref`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, noise, nscale, actv, wg, bg, wb, bb):
        if _build.wrapper_runs_kernel("fused_spade_modulate", x):
            launch, out = modulate_launcher(x, noise, nscale, actv, wg, bg,
                                            wb, bb)
            launch()
            fused_spade_modulate.launches += 1
        else:
            out = modulate_ref(x, noise, nscale, actv, wg, bg, wb, bb)
        ctx.save_for_backward(x, noise, nscale, actv, wg, bg, wb, bb)
        return out

    @staticmethod
    def backward(ctx, g):
        return tuple(ref_grads(ctx.needs_input_grad, g, ctx.saved_tensors,
                               modulate_ref))


def fused_spade_modulate(x, noise, nscale, actv, wg, bg, wb, bb):
    """instance_norm(x + noise*nscale) * (1 + conv(relu(actv), wg) + bg)
    + conv(relu(actv), wb) + bb (argument order of the JAX function).

    bf16 CUDA tensors launch the kernel (or raise); everything else takes
    the plain formulation. Differentiable: the backward is autograd of
    ``modulate_ref`` (``_Modulate``). ``fused_spade_modulate.launches``
    counts kernel launches.
    """
    return _Modulate.apply(x, noise, nscale, actv, wg, bg, wb, bb)


fused_spade_modulate.launches = 0
graphs.register_counters(fused_spade_modulate)
graphs.register_state(fast_spade_enabled)   # a dispatch switch: in every graph's key

