#!/usr/bin/env python
"""Formulations of the 3x3 conv that differ in how an input tile is staged.

PyTorch counterpart of ``tools/exp_pallas_conv2.py``. Two of its formulations
are hand-written CUDA kernels for sm_90a (``csrc/conv_exp.cu``):

  * ``conv_halo`` (the JAX ``conv_halo``): overlapping row tiles
    (B, nT, TH + 2, Wp, C) are gathered in device memory by tensor code, and
    a standard blocked kernel reads one tile per block with plain loads.
  * ``conv_dma`` (the JAX ``conv_dma``): pre-padded input, row bands through
    a double buffer filled by asynchronous copies, the nine taps in a loop
    with computed offsets.

Each wrapper launches its kernel for a CUDA tensor (bf16, th in 8 / 16 / 32;
or raises) and takes its plain version (``conv_halo_ref``, ``conv_dma_ref``)
only for a CPU tensor. ``<wrapper>.launches`` counts kernel launches. The
shift formulations of the JAX script (``roll``, ``prodroll``, ``e``, ``e2``)
are not ported yet.

    python -m hrviton_tpu_torch.tools.exp_conv2 [halo|dma|all]

with PROF_BATCH, PROF_ITERS, PROF_H, PROF_W, PROF_C and SKIP_CHECK as in the
JAX script. x is NHWC, w is HWIO.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.tools._common import (arr, check, check_conv_args,
                                             conv_ref, conv_wrapper, env_int,
                                             nine_taps, pad_input,
                                             problem_size, timeit)

__all__ = ["conv_halo", "conv_halo_ref", "conv_dma", "conv_dma_ref",
           "halo_tiles", "main"]

_NOT_PORTED = ("roll", "prodroll", "e", "e2")


def halo_tiles(x, th: int = 8, cinp: int | None = None):
    """The overlapping row tiles of the padded input, (B, H / th, th + 2, Wp,
    cinp): tile i holds padded rows [i * th, i * th + th + 2)."""
    xp = pad_input(x, cinp)
    nt = x.shape[1] // th
    idx = (torch.arange(nt, device=x.device) * th)[:, None] \
        + torch.arange(th + 2, device=x.device)[None, :]
    return xp[:, idx]


def conv_halo_ref(x, w, th: int = 8):
    """Plain version of ``conv_halo``: gather the tiles, then the nine taps
    as windows of each tile, in f32, rounded once."""
    check_conv_args("conv_halo", x, w, th)
    n, h, ww, cin = x.shape
    cout = w.shape[-1]
    wk = w.to(x.dtype).reshape(9, cin, cout)
    acc = nine_taps(halo_tiles(x, th), lambda ky, kx: wk[3 * ky + kx], th, ww)
    return acc.to(x.dtype).reshape(n, h, ww, cout)


def conv_dma_ref(x, w, th: int = 8):
    """Plain version of ``conv_dma``: pad, then the nine taps as windows of
    the padded image with the weights as (9, Cin, Cout), in f32, rounded
    once."""
    check_conv_args("conv_dma", x, w, th)
    _, h, ww, cin = x.shape
    wk = w.to(x.dtype).reshape(9, cin, w.shape[-1])
    acc = nine_taps(pad_input(x), lambda ky, kx: wk[3 * ky + kx], h, ww)
    return acc.to(x.dtype)


def conv_halo(x, w, th: int = 8):
    """3x3 conv from pre-gathered row tiles (the JAX ``conv_halo``). x: (B,
    H, W, Cin), w: (3, 3, Cin, Cout), H % th == 0. The gather is tensor code
    (``halo_tiles``); the kernel is ``conv_halo_kernel``."""
    return conv_wrapper(conv_halo, conv_halo_ref, "conv_halo_forward_bf16",
                        lambda t, cinp: halo_tiles(t, th, cinp), x, w, th)


def conv_dma(x, w, th: int = 8):
    """3x3 conv from a pre-padded input through a double-buffered band copy,
    taps in a loop (the JAX ``conv_dma``). Arguments as ``conv_halo``; the
    kernel is ``conv_dma_kernel``."""
    return conv_wrapper(conv_dma, conv_dma_ref, "conv_dma_forward_bf16",
                        pad_input, x, w, th)


conv_halo.launches = 0
conv_dma.launches = 0


def main(which=None, device="cuda"):
    """Check and time the selected formulations ('halo', 'dma' or 'all';
    from the command line, or 'halo'); returns {label: ms}."""
    if which is None:
        which = sys.argv[1] if len(sys.argv) > 1 else "halo"
    if which in _NOT_PORTED:
        raise NotImplementedError(
            f"the '{which}' formulation is not ported yet: ROADMAP.md, queue "
            f"2 (the shift formulations)")
    fns = {"halo": conv_halo, "dma": conv_dma}
    if which != "all" and which not in fns:
        raise ValueError(f"unknown formulation '{which}': halo, dma or all")
    chosen = list(fns) if which == "all" else [which]
    dev = resolve_device(device)
    b, h, ww, c, k = problem_size()
    rng = np.random.default_rng(0)
    x = arr(rng, (b, h, ww, c), device=dev)
    w = arr(rng, (3, 3, c, c), scale=0.1, device=dev)
    times = {}
    with torch.no_grad():
        if env_int("SKIP_CHECK", 0):
            times["library"] = timeit("library conv 3x3", conv_ref, x, w, iters=k)
            for name in chosen:
                for th in (8, 16):
                    times[f"{name} TH={th}"] = timeit(
                        f"{name} conv 3x3 TH={th}",
                        functools.partial(fns[name], th=th), x, w, iters=k)
            return times
        for name in chosen:
            check(name, fns[name], x, w)
        times["library"] = timeit("library conv 3x3", conv_ref, x, w, iters=k)
        if "halo" in chosen:
            times["halo TH=8"] = timeit("halo conv 3x3 TH=8 (gather and kernel)",
                                        conv_halo, x, w, iters=k)
            times["halo gather TH=8"] = timeit(
                "halo gather alone TH=8",
                lambda t: halo_tiles(t, 8), x, iters=k)
        if "dma" in chosen:
            times["dma TH=8"] = timeit("dma conv 3x3 TH=8", conv_dma, x, w, iters=k)
    return times


if __name__ == "__main__":
    main()
