"""What the conv experiments share: seeded inputs, the library convolution,
timing, the check against the library call, the padding of the plain
versions, the nine-tap plain arithmetic, the tap orders and the K-major weight
packing (re-exported from ``ops/conv_engine.py``), the plain product shift of
the shift formulations, and the launcher of the kernels in
``csrc/conv_tma.cu`` (``conv_halo``, ``conv_roll``, ``conv_band``,
``conv_dma``, ``conv_prodroll``, ``conv_e2``, ``conv_e``). Every kernel reads
x as it is.

Layouts are the JAX tools': activations NHWC, weights HWIO (3, 3, Cin, Cout).
The experiments compute a 3x3 stride-1 conv with zero padding 1, accumulate
in f32 over all nine taps and all of Cin and round once; no bias, no
activation.
"""

from __future__ import annotations

import ctypes
import functools
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.ops._build import check_tensor, pad_to
# the K-major, swizzled weight layout of csrc/conv_tma.cu (and of the model
# kernels' conv engine) lives with the ops
from hrviton_tpu_torch.ops.conv_engine import pack_weights_kmajor

__all__ = ["env_int", "problem_size", "arr", "conv_ref", "timeit", "check",
           "pad_input", "check_conv_args", "nine_taps", "pack_taps",
           "pack_kx", "pack_ky", "pack_weights_kmajor",
           "roll_p", "conv_launcher", "run_conv_exp", "conv_wrapper",
           "tensor_map_encode_us", "band_cluster", "band_active_clusters",
           "CARD_TH", "SHIFT_TH"]

CARD_TH = (8, 16, 32)      # band heights of conv_halo, conv_band and conv_dma
SHIFT_TH = (8, 16)         # and those of the shift formulations
# conv_tma.cu's product-shift kernels: N tiles of 64, two chunks a stage
_SHIFT_LAYOUT = functools.partial(pack_weights_kmajor, bn=64, kpad=32)


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def problem_size():
    """(B, H, W, C, K) from PROF_BATCH, PROF_H, PROF_W, PROF_C and PROF_ITERS,
    read when a ``main`` runs; the defaults are the tools' full size."""
    return (env_int("PROF_BATCH", 4), env_int("PROF_H", 1024),
            env_int("PROF_W", 768), env_int("PROF_C", 128),
            env_int("PROF_ITERS", 10))


def arr(rng: np.random.Generator, shape, dtype=torch.bfloat16, scale=1.0,
        device="cpu") -> torch.Tensor:
    """Standard-normal values from ``rng`` times ``scale`` on ``device``."""
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return torch.from_numpy(a).to(device).to(dtype)


def conv_ref(x, w):
    """The library convolution on an NHWC x and an HWIO w (one ``F.conv2d``);
    counterpart of the JAX tools' ``conv_xla``."""
    wk = w.to(x.dtype).permute(3, 2, 0, 1)
    return F.conv2d(x.permute(0, 3, 1, 2), wk, None, 1, 1).permute(0, 2, 3, 1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(name: str, fn, *args, iters: int = 10) -> float:
    """ms per call of ``fn(*args)``: a warm-up, then ``iters`` calls timed
    twice, the better of the two (CUDA events on the card, the host clock on
    the CPU). Prints and returns it."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn(*args)
    _sync(device)
    best = float("inf")
    for _ in range(2):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(iters):
                fn(*args)
            e1.record()
            torch.cuda.synchronize(device)
            ms = e0.elapsed_time(e1)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    print(f"{name:58s} {best / iters:9.2f} ms", flush=True)
    return best / iters


def check(name: str, fn, x, w, tol: float = 0.15) -> float:
    """max|fn(x, w) - conv_ref(x, w)|; raises unless it is below ``tol``."""
    ref = conv_ref(x, w)
    out = fn(x, w)
    d = (out.float() - ref.float()).abs().max().item()
    print(f"{name}: max|diff| {d:.5f} shape {tuple(out.shape)}", flush=True)
    if not d < tol:
        raise RuntimeError(f"{name}: max|diff| {d} is not below {tol}")
    return d


def check_conv_args(name: str, x, w, th: int) -> None:
    if x.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]) or w.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} (NHWC) does not go with "
                         f"w {tuple(w.shape)} (3, 3, Cin, Cout)")
    if th <= 0 or x.shape[1] % th:
        raise ValueError(f"{name}: h = {x.shape[1]} is not a multiple of the "
                         f"band height th = {th}")


def pad_input(x):
    """One zero row above and below, one zero column on the left and on the
    right up to Wp = W + 2 rounded up to 8, as the JAX tools pad: (B, H + 2,
    Wp, C). The plain versions' input; no kernel reads it."""
    ww = x.shape[2]
    wp = pad_to(ww + 2, 8)
    return F.pad(x, (0, 0, 1, wp - ww - 1, 1, 1))


def nine_taps(src, tap, rows: int, cols: int):
    """sum over ky, kx of src[..., ky:ky+rows, kx:kx+cols, :] @ tap(ky, kx) in
    f32, ky-major: the kernels' arithmetic, one product after another."""
    acc = None
    for ky in range(3):
        for kx in range(3):
            win = src[..., ky:ky + rows, kx:kx + cols, :].float()
            p = win @ tap(ky, kx).float()
            acc = p if acc is None else acc.add_(p)
    return acc


def pack_taps(w):
    """w as (3, 3, Cin, Cout): [ky][kx], the nine taps one by one."""
    return w


def pack_kx(w):
    """The kx taps stacked along channels in the order (2, 1, 0), for an
    operand whose channels are (t[j + 1], t[j], t[j - 1]): (3, 3 Cin, Cout),
    [ky][third * Cin + c]."""
    return torch.cat([w[:, 2], w[:, 1], w[:, 0]], dim=1)


def pack_ky(w):
    """The ky taps stacked along channels per kx, for an operand whose
    channels are three successive rows: (3, 3 Cin, Cout), [kx][ky * Cin + c]."""
    return torch.stack([torch.cat([w[0, kx], w[1, kx], w[2, kx]], dim=0)
                        for kx in range(3)])


def roll_p(p, kx: int):
    """The product shift with a zero boundary: the term of tap kx in
    acc[q] += p[q + kx - 1], columns on axis -2. The roll is circular, so the
    image's first column (kx = 0) or last (kx = 2) is masked to zero."""
    if kx == 1:
        return p
    r = torch.roll(p, 1 - kx, dims=-2)
    r[..., 0 if kx == 0 else -1, :] = 0.0
    return r


_ENTRIES = {
    # entry point: (csrc/<source>.cu, the band heights it admits, the layout
    # of the packed weights). All take (x, wk, out, B, H, W, C, CINP, COUT,
    # NP, TH, stream).
    "conv_band_forward_bf16": ("conv_tma", CARD_TH, pack_weights_kmajor),
    "conv_dma_forward_bf16": ("conv_tma", CARD_TH, pack_weights_kmajor),
    "conv_halo_forward_bf16": ("conv_tma", CARD_TH, pack_weights_kmajor),
    "conv_roll_forward_bf16": ("conv_tma", SHIFT_TH, pack_weights_kmajor),
    "conv_prodroll_forward_bf16": ("conv_tma", SHIFT_TH, _SHIFT_LAYOUT),
    "conv_e_forward_bf16": ("conv_tma", SHIFT_TH, _SHIFT_LAYOUT),
    "conv_e2_forward_bf16": ("conv_tma", SHIFT_TH, _SHIFT_LAYOUT),
}


# the BAND kind of conv_tma.cu: taps unrolled, taps in a loop
_BAND_ENTRIES = ("conv_band_forward_bf16", "conv_dma_forward_bf16")


def _declare(lib, source: str) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    for entry, (src, _, _) in _ENTRIES.items():
        if src == source:
            fn = getattr(lib, entry)
            fn.argtypes = [vp] * 3 + [i] * 8 + [vp]
            fn.restype = ctypes.c_int
    if source == "conv_tma":
        lib.conv_tma_encode_us.argtypes = [vp] * 2 + [i] * 7
        lib.conv_tma_encode_us.restype = ctypes.c_double
        lib.conv_band_variant_forward_bf16.argtypes = [vp] * 3 + [i] * 10 + [vp]
        lib.conv_band_variant_forward_bf16.restype = ctypes.c_int
        for fn in (lib.conv_band_cluster, lib.conv_band_active_clusters):
            fn.argtypes = [i]
            fn.restype = ctypes.c_int


def _load(source: str):
    return _build.load(source, lambda lib: _declare(lib, source))


def conv_launcher(entry: str, x, w, th: int, pack=pack_taps,
                  cluster: int | None = None):
    """What ``run_conv_exp`` does before its launch, done once: returns
    ``(launch, out)``, where ``launch()`` calls the bare C entry point on x
    and the packed weights and writes ``out``. Arguments as for
    ``run_conv_exp``; ``cluster`` (conv_band and conv_dma only) launches the
    kernel in clusters of that many blocks instead of its own (1, 2 or 4 at
    th = 8; to time the variants it was chosen from)."""
    source, ths, layout = _ENTRIES[entry]
    if cluster is not None and entry not in _BAND_ENTRIES:
        raise ValueError(f"{entry}: no cluster variants")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{entry}: the kernel takes bfloat16, got {x.dtype}")
    if th not in ths:
        raise ValueError(f"{entry}: the kernel is built for th in {ths}, "
                         f"got {th}")
    n, h, ww, cin = x.shape
    cout = w.shape[-1]
    dev = x.device
    check_tensor("x", x, (n, h, ww, cin), torch.bfloat16, dev)
    if w.device != dev:
        raise ValueError(f"w on {w.device}, expected {dev}")
    if cin % 8:
        raise ValueError(f"{entry}: Cin = {cin} is not a multiple of 8 "
                         f"(pixels must be 16-byte aligned)")
    wk = layout(w, pack)                    # (CINP / 16, NP / bn, 9, bn, 16)
    cinp, np_ = wk.shape[0] * wk.shape[4], wk.shape[1] * wk.shape[3]
    out = torch.empty((n, h, ww, cout), dtype=torch.bfloat16, device=dev)
    lib = _load(source)
    if cluster is None:
        fn, extra = getattr(lib, entry), ()
    else:
        fn = lib.conv_band_variant_forward_bf16
        extra = (cluster, _BAND_ENTRIES.index(entry))    # 1: the tap loop

    def launch():
        err = fn(x.data_ptr(), wk.data_ptr(), out.data_ptr(), n, h, ww, cin,
                 cinp, cout, np_, th, *extra,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return launch, out


def run_conv_exp(entry: str, x, w, th: int, pack=pack_taps):
    """Launch one conv kernel of ``csrc/conv_tma.cu`` on a CUDA x (bf16,
    NHWC, Cin % 8 == 0), read as it is, and w (3, 3, Cin, Cout). ``pack(w)``
    orders the weights as the kernel multiplies them; each of its nine (Cin,
    Cout) slices is zero-padded to the kernel's chunk and tile. Raises on
    what the kernels do not take."""
    launch, out = conv_launcher(entry, x, w, th, pack)
    launch()
    return out


def band_cluster(th: int) -> int:
    """The blocks of a cluster that share each stage's weights in conv_band's
    and conv_dma's kernels at band height ``th`` (``csrc/conv_tma.cu``'s
    BAND_CL; builds it at first use)."""
    return _load("conv_tma").conv_band_cluster(th)


def band_active_clusters(cluster: int) -> int:
    """How many clusters of ``cluster`` conv_band blocks at th = 8 the card
    holds at once (cudaOccupancyMaxActiveClusters; one block an SM)."""
    n = _load("conv_tma").conv_band_active_clusters(cluster)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError {-n}")
    return n


def tensor_map_encode_us(x, w, iters: int = 1000) -> float:
    """Microseconds of host time that one call of a kernel of
    ``csrc/conv_tma.cu`` spends encoding its two tensor maps (x as it is and
    the packed weights), the mean of ``iters`` encodings. x: CUDA, bf16, NHWC,
    Cin % 8 == 0."""
    wk = pack_weights_kmajor(w)
    n, h, ww, cin = x.shape
    us = _load("conv_tma").conv_tma_encode_us(
        x.data_ptr(), wk.data_ptr(), n, h, ww, cin, wk.shape[0] * wk.shape[4],
        wk.shape[1] * wk.shape[3], iters)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled failed")
    return us


def conv_wrapper(wrapper, plain, entry: str, x, w, th: int, pack=pack_taps):
    """What the conv wrappers do: a CPU tensor takes ``plain``, a CUDA tensor
    launches ``entry`` (or raises) and adds one to ``wrapper.launches``."""
    check_conv_args(wrapper.__name__, x, w, th)
    if x.device.type == "cpu":
        return plain(x, w, th)
    if x.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {x.device}")
    out = run_conv_exp(entry, x, w, th, pack)
    wrapper.launches += 1
    return out
