"""Fused SPADE-norm modulation chain.

PyTorch counterpart of ``hrviton_tpu/ops/spade_fused.py``. One call computes
a SPADENorm from the pre-relu ``actv = conv_shared(seg)`` on:

    mu, rsig   = instance stats of x + noise*nscale   # norm_stats, f32
    ------------------------------------------------------------- in-kernel:
    xn         = x + noise * nscale
    normalized = (xn - mu) * rsig
    out        = normalized * (1 + conv_g(relu(actv))) + conv_b(relu(actv))

The kernel is CUDA C++ for sm_90a (``csrc/spade_fused.cu``): bf16 inputs run
on the tensor cores, f32 inputs on plain FMA loops. gamma, beta and
``normalized`` never reach device memory. ``fused_spade_modulate`` launches
it for CUDA tensors (or raises) and takes the plain version ``modulate_ref``
only for CPU tensors. The instance statistics are a pass of their own, as in
the JAX package: ``norm_stats``, a one-pass CUDA kernel on the card (also the
fused unit's, ``ops/spade_block.py``) whose plain version is
``instance_stats``.

Layouts: activations NHWC (contiguous), weights OIHW (the port's module
layout). ``noise`` is (B, H, W, 1) float32, as the JAX package draws it.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.ops._build import KERNEL_DTYPES, check_tensor, pad_to

__all__ = ["fused_spade_modulate", "modulate_ref", "fused_spade_eligible",
           "enable_fast_spade", "fast_spade_enabled", "fast_spade",
           "instance_stats", "norm_stats", "modulate_flops",
           "modulate_bytes", "stats_bytes"]

_TH = 16         # the JAX kernel's rows per grid step: its gate's row rule
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
    on a CUDA device in float32 or bfloat16. At 1024x768 they admit the norms
    of up_2, up_3 and up_4. Always false on the CPU."""
    if not _ENABLED:
        return False
    _, h, w, _ = x_shape
    if not (h % _TH == 0 and w % 8 == 0 and h > _TH):
        return False
    if nhidden % 128 != 0:
        return False
    return (torch.device(device).type == "cuda" and dtype in KERNEL_DTYPES
            and h >= _MIN_H and w >= 96)


def instance_stats(x, noise, nscale):
    """f32 per-(batch, channel) instance stats of x + noise*nscale (NHWC):
    mean and 1/sqrt(biased var + eps), in one var_mean pass."""
    xnf = (x + (noise * nscale).to(x.dtype)).float()
    var, mu = torch.var_mean(xnf, dim=(1, 2), correction=0)
    return mu, torch.rsqrt(var + _EPS)


def norm_stats(x, noise, nscale):
    """The instance statistics as ``instance_stats`` gives them: mu and
    1/sqrt(var + eps) of x + noise*nscale per (image, channel), f32 (B, C).

    x: (B, H, W, C) float32 or bfloat16; noise: (B, H, W, 1) f32; nscale:
    (C,). A CUDA x launches the one-pass kernel of ``csrc/spade_fused.cu``
    (or raises): x is read once, xn formed in x's dtype as the plain version
    forms it, summed per thread in f32 about a shift and merged in f64. A
    CPU x takes ``instance_stats``.
    ``norm_stats.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return instance_stats(x, noise, nscale)
    if x.device.type != "cuda":
        raise ValueError(f"norm_stats: unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"norm_stats kernel takes float32/bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    dev = x.device
    check_tensor("x", x, (n, h, w, c), x.dtype, dev)
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
        int(x.dtype == torch.bfloat16), _EPS,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_stats_forward launch failed: cudaError {err}")
    norm_stats.launches += 1
    return mu, rsig


norm_stats.launches = 0


def modulate_ref(x, noise, nscale, actv, wg, bg, wb, bb):
    """Plain PyTorch formulation (the CPU path and the gold).

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
    gamma = F.conv2d(a, wg.to(dtype), padding=1).permute(0, 2, 3, 1) \
        + bg.to(dtype)
    beta = F.conv2d(a, wb.to(dtype), padding=1).permute(0, 2, 3, 1) \
        + bb.to(dtype)
    return normalized * (1.0 + gamma) + beta


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.spade_modulate_forward_bf16, lib.spade_modulate_forward_f32):
        fn.argtypes = [vp] * 9 + [i] * 6 + [vp]
        fn.restype = ctypes.c_int
    lib.instance_stats_forward.argtypes = [vp] * 6 + [i] * 5 + [ctypes.c_float, vp]
    lib.instance_stats_forward.restype = ctypes.c_int


def _pack_weights(wg, bg, wb, bb, dtype):
    """Kernel layouts. taps (9, NH, CP) per conv, CP = C padded to 32 with
    zeros; f32: wk = [gamma | beta] on the last axis, (9, NH, 2 CP); bf16:
    of each 64 columns the first 32 are gamma's and the last 32 beta's of
    the same channels, and chunks of 32 NH rows of every tap follow one
    another: (NH / 32, 9 * 32, 2 CP). bgb: (2, CP) f32, rounded through
    ``dtype``."""
    c, nh = wg.shape[0], wg.shape[1]
    cp = pad_to(c, 32)

    def taps(w):
        return F.pad(w.to(dtype).permute(2, 3, 1, 0).reshape(9, nh, c),
                     (0, cp - c))

    if dtype == torch.float32:
        wk = torch.cat([taps(wg), taps(wb)], dim=-1).contiguous()
    else:
        wk = torch.stack([taps(wg).reshape(9, nh, cp // 32, 32),
                          taps(wb).reshape(9, nh, cp // 32, 32)], dim=3)
        wk = wk.reshape(9, nh // 32, 32, 2 * cp).permute(1, 0, 2, 3).contiguous()
    bgb = F.pad(torch.stack([bg, bb]).to(dtype).float(), (0, cp - c)).contiguous()
    return wk, bgb, cp


def _modulate_cuda(x, noise, nscale, actv, wg, bg, wb, bb):
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_spade_modulate kernel takes float32/bfloat16, "
                        f"got {x.dtype}")
    n, h, w, c = x.shape
    nh = actv.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    if (nh % 32 or tuple(wg.shape) != (c, nh, 3, 3)
            or tuple(wb.shape) != (c, nh, 3, 3) or (bf16 and c % 2)):
        raise ValueError(f"unsupported modulate shapes: x {tuple(x.shape)}, actv "
                         f"{tuple(actv.shape)}, wg {tuple(wg.shape)}, wb "
                         f"{tuple(wb.shape)}")
    dev = x.device
    check_tensor("x", x, (n, h, w, c), x.dtype, dev)
    check_tensor("actv", actv, (n, h, w, nh), x.dtype, dev)
    noise = noise.reshape(n, h, w)
    check_tensor("noise", noise, (n, h, w), torch.float32, dev)
    lib = _build.load("spade_fused", _declare)
    mu, rsig = norm_stats(x, noise[..., None], nscale)
    nsc = nscale.float().contiguous()
    wk, bgb, cp = _pack_weights(wg, bg, wb, bb, x.dtype)
    out = torch.empty_like(x)
    fn = lib.spade_modulate_forward_bf16 if bf16 else lib.spade_modulate_forward_f32
    err = fn(x.data_ptr(), noise.data_ptr(), nsc.data_ptr(), mu.data_ptr(),
             rsig.data_ptr(), actv.data_ptr(), wk.data_ptr(), bgb.data_ptr(),
             out.data_ptr(), n, h, w, c, nh, cp,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spade_modulate_forward launch failed: cudaError {err}")
    fused_spade_modulate.launches += 1
    return out


def fused_spade_modulate(x, noise, nscale, actv, wg, bg, wb, bb):
    """instance_norm(x + noise*nscale) * (1 + conv(relu(actv), wg) + bg)
    + conv(relu(actv), wb) + bb (argument order of the JAX function).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    formulation. ``fused_spade_modulate.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return modulate_ref(x, noise, nscale, actv, wg, bg, wb, bb)
    if x.device.type != "cuda":
        raise ValueError(f"fused_spade_modulate: unsupported device {x.device}")
    return _modulate_cuda(x, noise, nscale, actv, wg, bg, wb, bb)


fused_spade_modulate.launches = 0


def modulate_flops(b, h, w, c, nh=128) -> int:
    """Operations of one call (2 per multiply-add): the gamma and beta 3x3
    convs over nh channels. The elementwise chain is negligible beside them
    and is not counted."""
    return 2 * b * h * w * 2 * 9 * nh * c


def modulate_bytes(b, h, w, c, nh=128, elem=2) -> int:
    """Bytes one call must move: x, actv and the noise (f32) read once, out
    written once, weights read once."""
    px = b * h * w
    return px * (2 * c + nh) * elem + px * 4 + 2 * 9 * nh * c * elem


def stats_bytes(b, h, w, c, elem=2) -> int:
    """Bytes the instance statistics must move: x and the noise (f32) read
    once, mu and rsig (f32) written once."""
    return b * h * w * (c * elem + 4) + 2 * b * c * 4
