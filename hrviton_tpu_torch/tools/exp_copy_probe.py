#!/usr/bin/env python
"""Probe: what does the halo-band copy cost by itself?

PyTorch counterpart of ``tools/exp_dma_probe.py``: the band copy of the fused
SPADE modulation with all arithmetic taken out, a passthrough of x. Band i
of an unpadded image is its rows [i * th - 1, i * th + th + 1) clipped to the
image (the first and the last band have one row less than a middle band),
copied into a slot of th + 2 rows; the th interior rows are written out.
``probe`` is a hand-written CUDA kernel for sm_90a
(``csrc/copy_probe.cu:band_copy_probe_kernel``: one TMA box of the unpadded
x a band into a ring of shared-memory slots, its interior rows back by one
TMA store, one thread issuing both; the rows outside the image arrive as
zeros and are never stored). The wrapper launches it for a CUDA tensor
(bf16, C % 8 == 0; or raises) and takes the plain version ``probe_ref`` only
for a CPU tensor. ``probe.launches`` counts kernel launches.

    python -m hrviton_tpu_torch.tools.exp_copy_probe

prints ms and GB/s (x read once, out written once) on x (4, 1024, 768, 128)
bf16 with PROF_TH (16) and PROF_ITERS (10); PROF_BATCH, PROF_H, PROF_W and
PROF_C change the size.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.ops._build import check_tensor
from hrviton_tpu_torch.tools._common import arr, env_int, problem_size, timeit

__all__ = ["probe", "probe_ref", "probe_launcher", "main"]


def _check_args(x, th: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"probe: x {tuple(x.shape)} is not (B, H, W, C)")
    if th <= 0 or x.shape[1] % th:
        raise ValueError(f"probe: h = {x.shape[1]} is not a multiple of the "
                         f"band height th = {th}")


def probe_ref(x, th: int = 16):
    """Plain version of ``probe``: the identity, written as the band walk.
    Slot row 0 of the first band and row th + 1 of the last are never filled
    (NaN here) and never written out."""
    _check_args(x, th)
    h = x.shape[1]
    out = torch.empty_like(x)
    slot = torch.empty((x.shape[0], th + 2) + tuple(x.shape[2:]), dtype=x.dtype,
                       device=x.device)
    for i in range(h // th):
        lo, hi = max(i * th - 1, 0), min(i * th + th + 1, h)
        first = 1 if i == 0 else 0
        slot.fill_(float("nan"))
        slot[:, first:first + hi - lo] = x[:, lo:hi]
        out[:, i * th:(i + 1) * th] = slot[:, 1:th + 1]
    return out


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.band_copy_probe_bf16.argtypes = [vp] * 2 + [i] * 5 + [vp]
    lib.band_copy_probe_bf16.restype = ctypes.c_int


def probe_launcher(x, th: int = 16):
    """What ``probe`` does before its launch, done once: returns ``(launch,
    out)``, where ``launch()`` calls the bare C entry point on the CUDA x
    (bf16, C % 8 == 0, th + 2 <= 256) and writes ``out``. Raises on what the
    kernel does not take."""
    _check_args(x, th)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"probe: the kernel takes bfloat16, got {x.dtype}")
    n, h, ww, c = x.shape
    if c % 8:
        raise ValueError(f"probe: the kernel's boxes are whole 16-byte pixels "
                         f"and take C % 8 == 0, got C = {c}")
    if th + 2 > 256:
        raise ValueError(f"probe: a band of th + 2 rows is one box of at most "
                         f"256 rows, got th = {th}")
    check_tensor("x", x, (n, h, ww, c), torch.bfloat16, x.device)
    out = torch.empty_like(x)
    lib = _build.load("copy_probe", _declare)

    def launch():
        err = lib.band_copy_probe_bf16(
            x.data_ptr(), out.data_ptr(), n, h, ww, c, th,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"band_copy_probe_bf16 launch failed: cudaError {err}")
    return launch, out


def probe(x, th: int = 16):
    """x through the halo-band copy (the JAX ``probe``). x: (B, H, W, C), H %
    th == 0; returns a tensor equal to x bit for bit."""
    _check_args(x, th)
    if x.device.type == "cpu":
        return probe_ref(x, th)
    if x.device.type != "cuda":
        raise ValueError(f"probe: unsupported device {x.device}")
    launch, out = probe_launcher(x, th)
    launch()
    probe.launches += 1
    return out


probe.launches = 0


def main(device="cuda"):
    """Check and time ``probe``; returns {'ms': ..., 'gb_per_s': ...}."""
    dev = resolve_device(device)
    b, h, ww, c, k = problem_size()
    th = env_int("PROF_TH", 16)
    x = arr(np.random.default_rng(0), (b, h, ww, c), device=dev)
    with torch.no_grad():
        if not torch.equal(probe(x, th), x):
            raise RuntimeError("probe: the passthrough changed x")
        ms = timeit(f"band copy passthrough TH={th}",
                    functools.partial(probe, th=th), x, iters=k)
    gb = 2 * x.numel() * x.element_size() / 1e9        # read once, written once
    print(f"band copy passthrough TH={th}: {ms:.2f} ms (~{gb / (ms / 1e3):.0f} "
          f"GB/s, x read once and out written once)", flush=True)
    return {"ms": ms, "gb_per_s": gb / (ms / 1e3)}


if __name__ == "__main__":
    main()
