#!/usr/bin/env python
"""The band-copy 3x3 conv beside the library conv and the port's own kernel.

PyTorch counterpart of ``tools/exp_pallas_conv.py``. ``conv_band`` is the
port's name for that script's ``conv_pallas``, which pads the input in
device memory, copies row bands of TH + 2 rows through a double buffer and
unrolls the nine shifted products. Here it is a hand-written CUDA kernel for
sm_90a (``csrc/conv_tma.cu:conv_band_tma_kernel``, the BAND kind): the input
is not padded, a band's tile with its zero border is one TMA box of x as it
is, the products run on ``wgmma``, and the blocks of a thread-block cluster,
adjacent column strips of the same band, share each stage's weights by one
multicast load. The wrapper launches it for a CUDA tensor (bf16, th in 8 /
16 / 32, Cin % 8 == 0; or raises) and takes the plain version
``conv_band_ref`` only for a CPU tensor. ``conv_band.launches`` counts kernel
launches.

    python -m hrviton_tpu_torch.tools.exp_conv

checks ``conv_band`` against the library conv and times the library conv,
``ops/conv3x3.py:conv3x3_wide`` and ``conv_band`` at TH = 8, 16, 32 on
x (4, 1024, 768, 128) and w (3, 3, 128, 128) in bf16 (PROF_BATCH, PROF_H,
PROF_W, PROF_C and PROF_ITERS change the size). x is NHWC, w is HWIO.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.ops.conv3x3 import conv3x3_wide
from hrviton_tpu_torch.tools._common import (arr, check_conv_args, conv_ref,
                                             conv_wrapper, nine_taps,
                                             pad_input, problem_size, timeit)

__all__ = ["conv_band", "conv_band_ref", "main"]


def conv_band_ref(x, w, th: int = 8):
    """Plain version of ``conv_band``: pad, then the nine taps as windows of
    the padded image with the weights as (3, 3, Cin, Cout), in f32, rounded
    once."""
    check_conv_args("conv_band", x, w, th)
    wd = w.to(x.dtype)
    acc = nine_taps(pad_input(x), lambda ky, kx: wd[ky, kx], x.shape[1],
                    x.shape[2])
    return acc.to(x.dtype)


def conv_band(x, w, th: int = 8):
    """3x3 conv through band tiles, taps unrolled (the JAX ``conv_pallas``).
    x: (B, H, W, Cin), w: (3, 3, Cin, Cout), H % th == 0, Cin % 8 == 0 on the
    card. x is read as it is: no padded copy."""
    return conv_wrapper(conv_band, conv_band_ref, "conv_band_forward_bf16",
                        x, w, th)


conv_band.launches = 0


def main(device="cuda"):
    """Check and time ``conv_band``; returns {label: ms}."""
    dev = resolve_device(device)
    b, h, ww, c, k = problem_size()
    rng = np.random.default_rng(0)
    x = arr(rng, (b, h, ww, c), device=dev)
    w = arr(rng, (3, 3, c, c), scale=0.1, device=dev)
    times = {}
    with torch.no_grad():
        ref = conv_ref(x, w).float()
        d = (conv_band(x, w).float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        del ref
        print(f"max|diff| {d:.5f}  rel {d / (scale + 1e-9):.6f}", flush=True)
        if not d < 0.15:
            raise RuntimeError(f"conv_band: max|diff| {d} is not below 0.15")
        tag = f"3x3 {c}->{c} @{h}x{ww}"
        times["library"] = timeit(f"library conv {tag}", conv_ref, x, w, iters=k)
        w_oihw = w.permute(3, 2, 0, 1)
        if dev.type == "cpu" or c % 32 == 0:     # the wide kernel's own rule
            times["conv3x3_wide"] = timeit(f"conv3x3_wide {tag}", conv3x3_wide,
                                           x, w_oihw, iters=k)
        for th in (8, 16, 32):
            if h % th:
                continue
            times[f"band TH={th}"] = timeit(
                f"band conv {tag} TH={th}",
                functools.partial(conv_band, th=th), x, w, iters=k)
    return times


if __name__ == "__main__":
    main()
