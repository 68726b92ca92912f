"""Host side of the TMA / wgmma conv engine (``csrc/conv_engine.cuh``).

The engine's kernels read their weights as one contiguous block per stage,
already in the order the 32-byte swizzle gives them in shared memory: for
each chunk of 16 input channels and each N tile of ``bn`` output columns,
the taps one after another, each (bn, 16) K-major (the 16 input channels of
an output column contiguous) with the two 16-byte halves of row n exchanged
where n & 4. ``pack_kmajor`` builds that layout from taps (T, K, N);
``pack_weights_kmajor`` is the same for the conv experiments' HWIO weights.

Packing costs a few small launches per call, so the kernels' wrappers keep
what they packed (``packed``): once per set of weight tensors, again when one
of them is written in place (its ``_version`` moves) or is another tensor.
Tensors without a version counter (made under ``torch.inference_mode``) are
packed per call. A pack that a CUDA graph being recorded reads is held with
the graph (``core/graphs.hold``), so the cache may drop it.
"""

from __future__ import annotations

import collections
import functools
import weakref
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.ops._build import pad_to

__all__ = ["KC", "swizzle32", "pack_kmajor", "pack_weights_kmajor", "packed",
           "pick_bn", "sm_count"]

KC = 16                 # input channels per stage: one wgmma K
_TOOLS_BN = 128         # the N tile of csrc/conv_tma.cu's conv_halo and conv_roll


def swizzle32(wk: torch.Tensor) -> torch.Tensor:
    """(..., N, 16) with N % 8 == 0 as the 32-byte swizzle lays it out: row n
    = 8 g + 4 b + r, column k = 8 h + e; half h is stored at h ^ b."""
    *lead, n, k = wk.shape
    v = wk.reshape(*lead, n // 8, 2, 4, 2, 8)
    v = torch.stack([v[..., 0, :, :, :], v[..., 1, :, :, :].flip(-2)], dim=-4)
    return v.reshape(*lead, n, k)


def pack_kmajor(taps: torch.Tensor, bn: int, kpad: int = KC) -> torch.Tensor:
    """taps (T, K, N), tap-major, K input by N output columns, as the engine
    reads them: bf16, K zero-padded to a multiple of ``kpad`` (chunks of 16)
    and N to tiles of ``bn``, (KP / 16, NP / bn, T, bn, 16)
    [chunk][tile][tap][n][k], swizzled."""
    t, k, n = taps.shape
    kp, np_ = pad_to(k, kpad), pad_to(n, bn)
    wk = F.pad(taps.to(torch.bfloat16), (0, np_ - n, 0, kp - k))
    wk = wk.reshape(t, kp // KC, KC, np_ // bn, bn).permute(1, 3, 0, 4, 2)
    return swizzle32(wk).contiguous()


def pack_weights_kmajor(w: torch.Tensor, pack: Optional[Callable] = None,
                        bn: int = _TOOLS_BN, kpad: int = KC) -> torch.Tensor:
    """w (3, 3, Cin, Cout) as the kernels of ``csrc/conv_tma.cu`` read it:
    bf16, ordered by ``pack`` (the nine taps as they are by default), in
    ``pack_kmajor``'s layout with N tiles of ``bn`` and Cin padded to a
    multiple of ``kpad`` (128 and 16 for conv_halo and conv_roll; 64 and 32,
    two chunks a stage, for conv_prodroll and conv_e2): (CINP / 16, NP / bn,
    9, bn, 16). All that their wrappers do to the weights per call."""
    cin, cout = w.shape[2:]
    wb = w.to(torch.bfloat16)
    return pack_kmajor((wb if pack is None else pack(wb)).reshape(9, cin, cout),
                       bn, kpad)


def pick_bn(cout: int, pixel_blocks: int, choices: Sequence[int]) -> int:
    """The N tile for ``cout`` output columns over ``pixel_blocks`` blocks of
    pixels: fewest waves of blocks over the card's SMs, each wave costing its
    tile width plus a fixed 32 columns' worth (the tile's A reads and its
    epilogue). 528 columns at 192 blocks: four tiles of 136."""
    sms = sm_count()

    def cost(bn):
        blocks = pixel_blocks * -(-cout // bn)
        return (-(-blocks // sms) * (bn + 32), bn)
    return min(choices, key=cost)


@functools.lru_cache(maxsize=None)
def sm_count() -> int:
    """SMs of the current card (132 on an H100 SXM, and where there is none)."""
    if not torch.cuda.is_available():
        return 132
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_CACHE_SIZE = 256


def _signature(t: Optional[torch.Tensor]):
    if t is None:
        return None
    return (t.data_ptr(), t._version, t.dtype, tuple(t.shape), t.device)


def packed(tag: str, tensors: Sequence[Optional[torch.Tensor]], make: Callable):
    """``make()``, or what it gave for the same ``tag`` and the same tensors
    while none of them was written since. A hit needs every tensor to be the
    very object it was (weak references: an address alone may belong to a
    new tensor) with the same data pointer, version counter, dtype and
    shape. Inference tensors have no version counter: never cached."""
    if any(t is not None and t.is_inference() for t in tensors):
        return make()
    key = (tag,) + tuple(id(t) for t in tensors)
    sig = tuple(_signature(t) for t in tensors)
    hit = _CACHE.get(key)
    if hit is not None:
        refs, old_sig, value = hit
        if old_sig == sig and all(
                (r is None and t is None) or (r is not None and r() is t)
                for r, t in zip(refs, tensors)):
            _CACHE.move_to_end(key)
            return graphs.hold(value)
    value = make()
    _CACHE[key] = (tuple(None if t is None else weakref.ref(t) for t in tensors),
                   sig, value)
    _CACHE.move_to_end(key)
    while len(_CACHE) > _CACHE_SIZE:
        _CACHE.popitem(last=False)
    return graphs.hold(value)
