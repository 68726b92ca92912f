#!/usr/bin/env python
"""Formulations of the 3x3 conv that differ in how an input tile is staged
and in how the taps' shifts are realised.

PyTorch counterpart of ``tools/exp_pallas_conv2.py``. Its six formulations
are hand-written CUDA kernels for sm_90a, and every wrapper hands x over as
it is: no padded or gathered copy. All six are built from Hopper's copy
engine and warpgroup products (``csrc/conv_tma.cu``: TMA tensor loads into a
ring of stages, ``wgmma``):

  * ``conv_halo`` (the JAX ``conv_halo``): a standard blocked kernel whose
    nine taps are nine windows of one halo tile. The JAX tool gathers the
    overlapping row tiles (B, nT, TH + 2, Wp, C) in device memory first; here
    a tile with its zero border is one box of a tensor map over the unpadded
    x, so neither the pad nor the gather exists.
  * ``conv_roll`` (the JAX ``conv_roll``): the three kx neighbours of a pixel
    packed into channels (K = 3 C), three products. The packing is three
    boxes of the same rows, one column apart.
  * ``conv_prodroll`` (the JAX ``conv_prodroll``): nine products of unshifted
    rows, the kx shift applied to the f32 products (three accumulators,
    shifted once per row). The JAX tool gathers padded row tiles first; here
    the rows with their zero border are one box of the unpadded x.
  * ``conv_e2`` (the JAX ``conv_e2``): the three ky rows packed into channels
    (K = 3 C), three products, the same product shift; the image's border
    columns are zero by the boxes' out-of-bounds fill. The packing is three
    boxes, one row apart.
  * ``conv_dma`` (the JAX ``conv_dma``, which pads x and copies row bands
    through a double buffer): the band's tile is one TMA box of the unpadded
    x, the nine taps run in a loop with computed offsets, and the blocks of a
    thread-block cluster share each stage's weights by one multicast load
    (``conv_band``'s kernel with the taps in a loop).
  * ``conv_e`` (the JAX ``conv_e``): nine unshifted products of the unpadded
    x and the product shift with the image's border columns masked. The JAX
    kernel's three band cases are the boxes' out-of-bounds fill; the shift
    is carried along each row, tile to tile, so no product column is
    computed twice.

Each wrapper launches its kernel for a CUDA tensor (bf16; th in 8 / 16 / 32
for ``conv_halo`` and ``conv_dma``, 8 / 16 for the shift formulations; Cin % 8
== 0; or raises) and takes its plain version (``conv_<name>_ref``, which
mirrors the JAX body step by step in f32) only for a CPU tensor.
``<wrapper>.launches`` counts kernel launches.

    python -m hrviton_tpu_torch.tools.exp_conv2 [halo|roll|prodroll|dma|e|e2|all]

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
                                             nine_taps, pack_kx, pack_ky,
                                             pad_input, problem_size, roll_p,
                                             timeit)

__all__ = ["conv_halo", "conv_halo_ref", "conv_dma", "conv_dma_ref",
           "conv_roll", "conv_roll_ref", "conv_prodroll", "conv_prodroll_ref",
           "conv_e", "conv_e_ref", "conv_e2", "conv_e2_ref", "halo_tiles",
           "band_tiles", "main"]


def halo_tiles(x, th: int = 8):
    """The overlapping row tiles of the padded input, (B, H / th, th + 2, Wp,
    C): tile i holds padded rows [i * th, i * th + th + 2). What the JAX
    tools gather before their kernels; here part of the plain versions only,
    since the kernels' tiles are TMA boxes of the unpadded x."""
    xp = pad_input(x)
    nt = x.shape[1] // th
    idx = (torch.arange(nt, device=x.device) * th)[:, None] \
        + torch.arange(th + 2, device=x.device)[None, :]
    return xp[:, idx]


def band_tiles(x, th: int = 8):
    """The band slots of the unpadded x as ``conv_e`` fills them, (B, H / th,
    th + 2, W, C): band i holds rows [i * th - 1, i * th + th + 1) of x. The
    first band has th + 1 of them, in slot rows 1 .., the last band th + 1 in
    rows 0 .., a middle band th + 2; the missing row is zero (a one-band image
    misses both). Part of the plain versions only."""
    n, h, ww, c = x.shape
    nt = h // th
    tiles = x.new_zeros((n, nt, th + 2, ww, c))
    for i in range(nt):
        lo, hi = max(i * th - 1, 0), min(i * th + th + 1, h)
        first = 1 if i == 0 else 0
        tiles[:, i, first:first + hi - lo] = x[:, lo:hi]
    return tiles


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


def conv_roll_ref(x, w, th: int = 8):
    """Plain version of ``conv_roll``: gather the tiles, roll each by one
    column either way (circularly over Wp), stack (t[j + 1], t[j], t[j - 1])
    along channels, three products of K = 3 Cin against ``pack_kx(w)`` in
    f32, round once over all Wp columns and keep columns 1 .. W (output
    column q is stacked column q + 1; the columns the roll wraps, 0 and
    Wp - 1, are not kept)."""
    check_conv_args("conv_roll", x, w, th)
    n, h, ww, _ = x.shape
    t = halo_tiles(x, th).float()
    s = torch.cat([torch.roll(t, -1, dims=3), t, torch.roll(t, 1, dims=3)], -1)
    wk = pack_kx(w.to(x.dtype)).float()
    acc = None
    for ky in range(3):
        p = s[:, :, ky:ky + th] @ wk[ky]
        acc = p if acc is None else acc.add_(p)
    return acc.to(x.dtype)[:, :, :, 1:1 + ww].reshape(n, h, ww, w.shape[-1])


def conv_prodroll_ref(x, w, th: int = 8):
    """Plain version of ``conv_prodroll``: gather the tiles, nine products of
    unshifted rows (only the ky slice moves) in f32, each rolled by -kx along
    the Wp columns (circularly) before it is added, one rounding, columns
    0 .. W - 1 kept (q + kx <= W + 1 <= Wp - 1 there: the wrap is not kept)."""
    check_conv_args("conv_prodroll", x, w, th)
    n, h, ww, cin = x.shape
    cout = w.shape[-1]
    t = halo_tiles(x, th).float()
    wk = w.to(x.dtype).reshape(9, cin, cout).float()
    acc = None
    for ky in range(3):
        rows = t[:, :, ky:ky + th]
        for kx in range(3):
            p = rows @ wk[3 * ky + kx]
            if kx:
                p = torch.roll(p, -kx, dims=3)
            acc = p if acc is None else acc.add_(p)
    return acc.to(x.dtype)[:, :, :, :ww].reshape(n, h, ww, cout)


def conv_e_ref(x, w, th: int = 8):
    """Plain version of ``conv_e``: the band slots of the unpadded x (zero
    row above the first band and below the last), nine products of unshifted
    rows in f32, each shifted by ``roll_p`` (border column masked), rounded
    once."""
    check_conv_args("conv_e", x, w, th)
    n, h, ww, cin = x.shape
    cout = w.shape[-1]
    t = band_tiles(x, th).float()
    wk = w.to(x.dtype).reshape(9, cin, cout).float()
    acc = None
    for ky in range(3):
        rows = t[:, :, ky:ky + th]
        for kx in range(3):
            p = roll_p(rows @ wk[3 * ky + kx], kx)
            acc = p if acc is None else acc.add_(p)
    return acc.to(x.dtype).reshape(n, h, ww, cout)


def conv_e2_ref(x, w, th: int = 8):
    """Plain version of ``conv_e2``: the band slots as for ``conv_e``, the
    three ky rows stacked along channels (K = 3 Cin), three products against
    ``pack_ky(w)`` in f32, each shifted by ``roll_p``, rounded once."""
    check_conv_args("conv_e2", x, w, th)
    n, h, ww, _ = x.shape
    t = band_tiles(x, th).float()
    rows3 = torch.cat([t[:, :, ky:ky + th] for ky in range(3)], -1)
    wk = pack_ky(w.to(x.dtype)).float()
    acc = None
    for kx in range(3):
        p = roll_p(rows3 @ wk[kx], kx)
        acc = p if acc is None else acc.add_(p)
    return acc.to(x.dtype).reshape(n, h, ww, w.shape[-1])


def conv_halo(x, w, th: int = 8):
    """3x3 conv whose taps are windows of one halo tile per step (the JAX
    ``conv_halo``). x: (B, H, W, Cin), w: (3, 3, Cin, Cout), H % th == 0, Cin
    % 8 == 0 on the card. x is read as it is: a tile with its zero border is
    one TMA box; the kernel is ``conv_halo_tma_kernel``."""
    return conv_wrapper(conv_halo, conv_halo_ref, "conv_halo_forward_bf16",
                        x, w, th)


def conv_dma(x, w, th: int = 8):
    """3x3 conv through band tiles, taps in a loop (the JAX ``conv_dma``).
    Arguments as ``conv_halo``. x is read as it is: no padded copy; the
    kernel is ``conv_dma_tma_kernel``."""
    return conv_wrapper(conv_dma, conv_dma_ref, "conv_dma_forward_bf16", x, w,
                        th)


def conv_roll(x, w, th: int = 8):
    """3x3 conv with the kx neighbours packed into channels (the JAX
    ``conv_roll``). Arguments as ``conv_halo``, th 8 or 16. x is read as it
    is: the packed tile is three TMA boxes one column apart; the kernel is
    ``conv_roll_tma_kernel``."""
    return conv_wrapper(conv_roll, conv_roll_ref, "conv_roll_forward_bf16",
                        x, w, th, pack_kx)


def conv_prodroll(x, w, th: int = 8):
    """3x3 conv from nine products of unshifted rows with the kx shift
    applied to the f32 products (the JAX ``conv_prodroll``). Arguments as
    ``conv_roll``. x is read as it is: a stage's rows are one TMA box; the
    kernel is ``conv_prodroll_tma_kernel``."""
    return conv_wrapper(conv_prodroll, conv_prodroll_ref,
                        "conv_prodroll_forward_bf16", x, w, th)


def conv_e(x, w, th: int = 8):
    """3x3 conv from the unpadded x: three-case band copy, unshifted
    products, masked product shift (the JAX ``conv_e``). Arguments as
    ``conv_roll``, Cin % 8 == 0 on the card. x is read as it is: a stage's
    rows are one TMA box; the kernel is ``conv_e_tma_kernel``."""
    return conv_wrapper(conv_e, conv_e_ref, "conv_e_forward_bf16", x, w, th)


def conv_e2(x, w, th: int = 8):
    """As ``conv_e`` with the ky rows packed into channels (the JAX
    ``conv_e2``). x is read as it is: the packed tile is three TMA boxes one
    row apart; the kernel is ``conv_e2_tma_kernel``."""
    return conv_wrapper(conv_e2, conv_e2_ref, "conv_e2_forward_bf16", x, w,
                        th, pack_ky)


# selector -> (wrapper, band heights main times after its checks)
_FORMULATIONS = {"halo": (conv_halo, (8,)), "roll": (conv_roll, (8,)),
                 "prodroll": (conv_prodroll, (8, 16)), "dma": (conv_dma, (8,)),
                 "e": (conv_e, ()), "e2": (conv_e2, ())}
for _fn, _ in _FORMULATIONS.values():
    _fn.launches = 0


def main(which=None, device="cuda"):
    """Check and time the selected formulations ('halo', 'roll', 'prodroll',
    'dma', 'e', 'e2' or 'all'; from the command line, or 'halo'); returns
    {label: ms}. As in the JAX script, 'e' and 'e2' are checked but timed
    only under SKIP_CHECK, where every selected formulation is timed at TH 8
    and 16."""
    if which is None:
        which = sys.argv[1] if len(sys.argv) > 1 else "halo"
    if which != "all" and which not in _FORMULATIONS:
        raise ValueError(f"unknown formulation '{which}': "
                         f"{', '.join(_FORMULATIONS)} or all")
    chosen = list(_FORMULATIONS) if which == "all" else [which]
    dev = resolve_device(device)
    b, h, ww, c, k = problem_size()
    rng = np.random.default_rng(0)
    x = arr(rng, (b, h, ww, c), device=dev)
    w = arr(rng, (3, 3, c, c), scale=0.1, device=dev)
    times = {}
    skip_check = env_int("SKIP_CHECK", 0)
    with torch.no_grad():
        if not skip_check:
            for name in chosen:
                check(name, _FORMULATIONS[name][0], x, w)
        times["library"] = timeit("library conv 3x3", conv_ref, x, w, iters=k)
        for name in chosen:
            fn, ths = _FORMULATIONS[name]
            for th in (8, 16) if skip_check else ths:
                times[f"{name} TH={th}"] = timeit(
                    f"{name} conv 3x3 TH={th}", functools.partial(fn, th=th),
                    x, w, iters=k)
            if name == "halo" and not skip_check:
                # what the JAX tool pays before its kernels; no kernel here
                # gathers
                times["halo gather TH=8"] = timeit(
                    "halo gather alone TH=8", lambda t: halo_tiles(t, 8), x,
                    iters=k)
    return times


if __name__ == "__main__":
    main()
