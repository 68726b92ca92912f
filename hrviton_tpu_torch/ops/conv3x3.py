"""Fused [pre-activation ->] 3x3 stride-1 pad-1 conv [-> bias].

PyTorch counterpart of ``hrviton_tpu/ops/conv3x3.py``. Two hand-written CUDA
kernels for sm_90a (``csrc/conv3x3.cu``) stand where the JAX package has two
Pallas kernels:

  * ``conv3x3_wide``: wide channel counts (the JAX ``_conv3x3_pallas``). The
    bias joins the f32 accumulator and the sum is rounded once. It runs on
    the TMA / wgmma conv engine (``csrc/conv_engine.cuh``), with its weights
    packed once per weight tensor (``ops/conv_engine.py``).
  * ``conv3x3_small``: small channel counts, 3 * Cin <= 128 and 3 * Cout <=
    128 (the JAX ``_conv3x3_views_pallas``). The accumulator is rounded,
    then the bias is added in the output dtype. It runs on the same engine,
    in N tiles of 8, 16 or 32 columns; a Cin below 15 that is no multiple of
    8 (9 channels: 18-byte pixels) is read as rows of W * Cin elements
    (``narrow_box``), a larger one from a copy of x with its channels
    zero-padded to a multiple of 8 (``small_channels``).

Each kernel runs for bf16 on the card, and the plain version ``conv3x3_ref``,
with the kernel's own rounding chain, runs everywhere else
(``_build.runs_kernel``). ``conv3x3`` sends a call to the kernel its gate admits, as the JAX
``conv3x3`` does: the small-channel gate (``_views_eligible``, under the
module switch ``_VIEWS``) is asked first, then ``conv3x3_eligible`` (under
``fast_conv``). The layers ask the same gates through ``kernel_for`` and keep
their library convolution where neither admits the call.

Gradients, as the JAX custom VJPs give them: each wrapper is a
``torch.autograd.Function`` whose forward launches the kernel where it runs
(the plain version elsewhere) and whose backward is autograd of the plain version
``conv3x3_ref`` (round, then add the bias, as the JAX ``_conv3x3_ref``) on
the saved inputs (JAX ``_cvjp_bwd``, the backward of both Pallas kernels).
Under the ``taps_wgrad`` switch (JAX ``_conv3x3_taps``), a library 3x3 conv
that needs a gradient runs ``conv3x3_taps``: the library forward, the input
gradient as the library's transposed conv in x's memory format (the
activations' channels_last), and the weight gradient as nine
tap products with no im2col buffer (``wgrad_taps``), by dtype: bf16 on the
card the hand-written kernel ``wgrad3x3`` (``csrc/wgrad3x3.cu``: TMA boxes
of x and g, bf16 products on wgmma summed in f32, one rounding to w's
dtype), bf16 on the CPU its plain version ``wgrad3x3_ref``, f32 the f32 tap
products over chunks of rows (``_wgrad_rows``: tensor cores would need
TF32). The dispatch keeps the JAX order: the small-channel gate, then the
wide gate, then taps, then the library.

Layouts: activations NHWC (contiguous), weights OIHW (the port's module
layout), so a gate's ``w_shape`` is (Cout, Cin, 3, 3).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from hrviton_tpu_torch.core import graphs, precision
from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.ops._build import (ACT_CODES, check_tensor, pad_to,
                                          ref_grads, runs_kernel,
                                          wrapper_runs_kernel)
from hrviton_tpu_torch.ops.conv_engine import (pack_kmajor, packed, pick_bn,
                                               sm_count)
from hrviton_tpu_torch.utils import profiling

__all__ = ["conv3x3", "conv3x3_wide", "conv3x3_small", "conv3x3_ref",
           "conv3x3_eligible", "kernel_for", "enable_fast_conv",
           "fast_conv_enabled", "fast_conv", "activation", "leaky_slope",
           "small_tiles", "small_weights", "narrow_box", "small_channels",
           "small_launcher", "conv3x3_taps", "wgrad_taps", "taps_wgrad",
           "taps_wgrad_enabled", "wgrad3x3", "wgrad3x3_ref", "wgrad3x3_launcher",
           "wgrad3x3_tiles", "wgrad3x3_splits", "wgrad3x3_plan", "wgrad_path"]

_TH = 8          # the JAX kernels' rows per grid step: their gates' row rule
_WIDE_BN = (32, 64, 96, 128, 136)   # the N tiles conv3x3_wide is built for
_SMALL_BN = (8, 16, 32)             # and conv3x3_small
_HALO_COLS = 34  # columns of the engine's halo tile that its products read
_ENABLED = False
_TAPS_WGRAD = False
# The small-channel kernel's switch: a module switch with no config knob and
# off by default, as in the JAX package. Callers set it and restore it.
_VIEWS = False


def enable_fast_conv(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def fast_conv_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def fast_conv(on: bool = True):
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    try:
        yield
    finally:
        _ENABLED = prev


def taps_wgrad_enabled() -> bool:
    return _TAPS_WGRAD


@contextlib.contextmanager
def taps_wgrad(on: bool = True):
    """Inside the block, the weight gradient of a library 3x3/s1/p1 conv
    is the tap products' (``conv3x3_taps``); the forward is unchanged."""
    global _TAPS_WGRAD
    prev = _TAPS_WGRAD
    _TAPS_WGRAD = bool(on)
    try:
        yield
    finally:
        _TAPS_WGRAD = prev


@functools.lru_cache(maxsize=None)
def leaky_slope(dtype: torch.dtype) -> float:
    """0.2 rounded to ``dtype``. The JAX package multiplies a tensor by the
    slope in the tensor's own dtype (bf16: 0.2001953125), so the port does
    too; in float32 this is float32(0.2)."""
    return float(torch.tensor(0.2, dtype=dtype))


def activation(x: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    if kind is None:
        return x
    if kind == "relu":
        return F.relu(x)
    if kind == "leaky0.2":
        return F.leaky_relu(x, leaky_slope(x.dtype))
    raise ValueError(kind)


def _is_3x3_s1_p1(w_shape, stride, padding) -> bool:
    return (tuple(w_shape[-2:]) == (3, 3) and tuple(stride) == (1, 1)
            and tuple(padding) == (1, 1))


def conv3x3_eligible(x_shape, w_shape, stride, padding, dtype, device) -> bool:
    """Gate of the wide kernel: ``fast_conv`` on, and the JAX gate's shape
    rules (h % 8 == 0, w % 8 == 0, h > 8, h >= 128, w >= 96, Cin % 128 == 0)
    where the kernel runs (``_build.runs_kernel``: bf16 on the card)."""
    if not _ENABLED or not _is_3x3_s1_p1(w_shape, stride, padding):
        return False
    _, h, w, cin = x_shape
    if not (h % _TH == 0 and w % 8 == 0 and h > _TH):
        return False
    return (runs_kernel(dtype, device) and h >= 128 and w >= 96
            and cin % 128 == 0)


def _views_eligible(x_shape, w_shape, stride, padding, dtype, device) -> bool:
    """Gate of the small-channel kernel: ``_VIEWS`` on, and the JAX gate's
    shape rules (h % 8 == 0, w % 128 == 0, h > 8, h >= 512, 3 * Cin <= 128,
    3 * Cout <= 128) where the kernel runs (``_build.runs_kernel``)."""
    if not _VIEWS or not _is_3x3_s1_p1(w_shape, stride, padding):
        return False
    _, h, w, cin = x_shape
    if not (h % _TH == 0 and w % 128 == 0 and h > _TH):
        return False
    return (runs_kernel(dtype, device) and w_shape[0] * 3 <= 128
            and cin * 3 <= 128 and h >= 512)


def conv3x3_ref(x, w, bias=None, pre_act=None, fused_bias: bool = False):
    """Plain PyTorch version (the route of everything but bf16 on the card,
    and the gold of both kernels).

    x: (N, H, W, Cin); w: (Cout, Cin, 3, 3); bias: (Cout,) or None. The conv
    accumulates in f32. ``fused_bias=False`` (the small-channel kernel's
    chain, and the JAX ``_conv3x3_ref``'s): round to x's dtype, then add the
    bias in that dtype. ``fused_bias=True`` (the wide kernel's chain): add
    the bias, rounded to x's dtype, to the f32 sum and round once. In
    float32 the two are the same."""
    dtype = x.dtype
    a = activation(x, pre_act).permute(0, 3, 1, 2)
    wd = w.to(dtype)
    if not fused_bias or dtype == torch.float32:
        with precision.exact(dtype):
            y = F.conv2d(a, wd, None, 1, 1).permute(0, 2, 3, 1)
        return y if bias is None else y + bias.to(dtype)
    with precision.no_tf32():               # the f32 sum of the bf16 chain
        y = F.conv2d(a.float(), wd.float(), None, 1, 1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(dtype).float()
    return y.to(dtype)


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_wide_forward_bf16.argtypes = [vp] * 4 + [i] * 8 + [vp]
    lib.conv3x3_wide_forward_bf16.restype = ctypes.c_int
    lib.conv3x3_small_forward_bf16.argtypes = [vp] * 4 + [i] * 9 + [vp]
    lib.conv3x3_small_forward_bf16.restype = ctypes.c_int


def wide_weights(w, bias, bn: int):
    """The wide bf16 kernel's operands for N tiles of ``bn``: the taps in the
    engine's layout, (CINP / 16, NP / bn, 9, bn, 16), and the bias rounded
    through bf16, f32, zero-padded to NP; packed once per (w, bias)."""
    def make():
        cout, cin = w.shape[0], w.shape[1]
        wk = pack_kmajor(w.permute(2, 3, 1, 0).reshape(9, cin, cout), bn)
        return wk, _bias_f32(bias, wk.shape[1] * bn, w.device)
    return packed(f"conv3x3_wide/{bn}", (w, bias), make)


def wide_bn(x_shape, cout: int) -> int:
    """The N tile of the wide bf16 kernel for x (N, H, W, Cin): the choice
    of ``conv_engine.pick_bn`` over the engine's 8 x 32-pixel blocks."""
    n, h, w, _ = x_shape
    return pick_bn(cout, n * -(-h // 8) * -(-w // 32), _WIDE_BN)


def small_tiles(cout: int):
    """(BN, NTILES) of the small bf16 kernel: the narrowest of
    ``_SMALL_BN`` that holds Cout (Cout = 3: one tile of 8), else tiles of
    32."""
    bn = next((bn for bn in _SMALL_BN if bn >= cout), _SMALL_BN[-1])
    return bn, -(-cout // bn)


def small_weights(w, bias, bn: int):
    """The small bf16 kernel's operands for N tiles of ``bn``: the taps in
    the engine's layout, (CINP / 16, NP / bn, 9, bn, 16) with Cin
    zero-padded to 16 (the channels a narrow input's spread leaves zero),
    and the bias rounded through bf16, f32, zero-padded to NP; packed once
    per (w, bias)."""
    def make():
        cout, cin = w.shape[0], w.shape[1]
        wk = pack_kmajor(w.permute(2, 3, 1, 0).reshape(9, cin, cout), bn)
        return wk, _bias_f32(bias, wk.shape[1] * bn, w.device)
    return packed(f"conv3x3_small/{bn}", (w, bias), make)


def narrow_box(cin: int) -> int:
    """Elements of each of the two boxes in which the small kernel reads a
    halo row of a narrow input (Cin < 15, no multiple of 8): together they
    hold the 34 pixels its products read, 34 * Cin elements, from the 16
    bytes at or left of the first (up to 7 elements more); each a multiple
    of 8 elements (16 bytes) and at most 256. 9 channels: 160."""
    if not 0 < cin < 15 or cin % 8 == 0:
        raise ValueError(f"narrow_box: Cin {cin} is not a narrow input")
    return pad_to(-(-(_HALO_COLS * cin + 7) // 2), 8)


def small_channels(cin: int) -> int:
    """The channels of the input the small bf16 kernel reads for Cin: Cin
    itself where it is a multiple of 8 (whole 16-byte rows of a 4-D box) or
    below 15 (a narrow input, ``narrow_box``); else Cin padded to a multiple
    of 8, in a copy of x that the wrapper makes (a halo row of 34 pixels of
    15 to 42 channels would take three to six boxes of a narrow stage). No
    site of the generator has such a Cin (9 and 32 do)."""
    return cin if cin % 8 == 0 or cin < 15 else pad_to(cin, 8)


def _bias_f32(bias, np_: int, device):
    """The bias as the kernels take it: rounded through bf16, f32, zero
    padded to ``np_`` (zeros for no bias)."""
    if bias is None:
        return torch.zeros(np_, dtype=torch.float32, device=device)
    return F.pad(bias.to(torch.bfloat16).float(),
                 (0, np_ - bias.shape[0])).contiguous()


def _launcher(kind: str, x, w, bias, pre_act):
    """Check the arguments, pack the weights and allocate the output; return
    (launch, out): ``launch()`` makes the one kernel launch into ``out`` and
    nothing else, and raises if it fails. bf16 CUDA tensors only."""
    if pre_act not in ACT_CODES:
        raise ValueError(pre_act)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} (NHWC) does not go with "
                         f"w {tuple(w.shape)} (Cout, Cin, 3, 3)")
    n, h, ww, cin = x.shape
    cout = w.shape[0]
    dev = x.device
    check_tensor("x", x, (n, h, ww, cin), torch.bfloat16, dev)
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected ({cout},)")
    if w.device != dev:
        raise ValueError(f"w on {w.device}, expected {dev}")
    small = kind == "small"
    if small and (cin * 3 > 128 or cout * 3 > 128):
        raise ValueError(f"conv3x3_small takes 3 * Cin <= 128 and 3 * Cout <= "
                         f"128, got {cin} -> {cout}")
    box, xk = 0, x
    if cin % 8:
        if not small:
            raise ValueError(f"conv3x3_wide takes Cin % 8 == 0, got {cin}")
        if small_channels(cin) != cin:
            xk = F.pad(x, (0, small_channels(cin) - cin))
        elif ww * cin % 8:
            raise ValueError(f"conv3x3_small takes a Cin below 15 with W * Cin "
                             f"% 8 == 0; got Cin {cin}, W {ww}")
        else:
            box = narrow_box(cin)
    lib = _build.load("conv3x3", _declare)
    out = torch.empty((n, h, ww, cout), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    act = ACT_CODES[pre_act]
    if small:
        bn = small_tiles(cout)[0]
        wk, bk = small_weights(w, bias, bn)
        fn = lib.conv3x3_small_forward_bf16
        args = (xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                n, h, ww, xk.shape[-1], cout, bn, wk.shape[1], act, box, stream)
    else:
        bn = wide_bn(x.shape, cout)
        wk, bk = wide_weights(w, bias, bn)
        fn = lib.conv3x3_wide_forward_bf16
        args = (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                n, h, ww, cin, cout, bn, wk.shape[1], act, stream)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"conv3x3 ({kind}) launch failed: cudaError {err}")
    launch.operands = (xk, wk, bk)              # alive while launch may run
    return launch, out


def small_launcher(x, w, bias=None, pre_act=None):
    """``conv3x3_small``'s launch prepared, as (launch, out): ``launch()``
    is the bare kernel launch, with the weights already packed (for timing
    the kernel alone). bf16 CUDA tensors only."""
    return _launcher("small", x, w, bias, pre_act)


def _run(wrapper, kind: str, fused_bias: bool, x, w, bias, pre_act):
    if not wrapper_runs_kernel(f"conv3x3_{kind}", x):
        return conv3x3_ref(x, w, bias, pre_act, fused_bias=fused_bias)
    launch, out = _launcher(kind, x, w, bias, pre_act)
    launch()
    wrapper.launches += 1
    return out


class _KernelConv(torch.autograd.Function):
    """One of the two kernels as a differentiable op: the forward is the
    wrapper's launch, the backward autograd of ``conv3x3_ref`` (JAX
    ``_cvjp_bwd``)."""

    @staticmethod
    def forward(ctx, kind, x, w, bias, pre_act):
        wrapper = conv3x3_wide if kind == "wide" else conv3x3_small
        out = _run(wrapper, kind, kind == "wide", x, w, bias, pre_act)
        ctx.pre_act = pre_act
        ctx.save_for_backward(x, w, bias)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        pre_act = ctx.pre_act
        grads = ref_grads(ctx.needs_input_grad[1:4], g, (x, w, bias),
                          lambda x_, w_, b_: conv3x3_ref(x_, w_, b_, pre_act))
        return (None, *grads, None)


def conv3x3_wide(x, w, bias=None, pre_act=None):
    """The wide kernel: pre_act -> 3x3/s1/p1 conv -> + bias in f32 -> one
    round. x: (N, H, W, Cin) contiguous; w: (Cout, Cin, 3, 3); bias: (Cout,)
    or None. bf16 CUDA tensors launch the kernel (or raise; it needs Cin % 8
    == 0); everything else takes ``conv3x3_ref`` with ``fused_bias=True``.
    Differentiable (``_KernelConv``). ``conv3x3_wide.launches`` counts
    kernel launches."""
    return _KernelConv.apply("wide", x, w, bias, pre_act)


def conv3x3_small(x, w, bias=None, pre_act=None):
    """The small-channel kernel: pre_act -> 3x3/s1/p1 conv -> round -> + bias
    in the output dtype, for 3 * Cin <= 128 and 3 * Cout <= 128. Arguments as
    ``conv3x3_wide``. bf16 CUDA tensors launch the kernel (or raise; a Cin
    below 15 that is no multiple of 8 needs W * Cin % 8 == 0, and a Cin from
    15 to 42 that is none is read from a zero-padded copy of x); everything
    else takes ``conv3x3_ref``. Differentiable (``_KernelConv``).
    ``conv3x3_small.launches`` counts kernel launches."""
    return _KernelConv.apply("small", x, w, bias, pre_act)


conv3x3_wide.launches = 0
conv3x3_small.launches = 0
graphs.register_counters(conv3x3_wide, conv3x3_small)   # counted in replays too
# the dispatch switches: in every graph's key
graphs.register_state(lambda: (_ENABLED, _TAPS_WGRAD, _VIEWS))


def _row_chunk(h: int) -> int:
    for r in (128, 64, 32, 16, 8, 4, 2):
        if h % r == 0 and h > r:
            return r
    return h


def _wgrad_rows(x, g, pre_act=None):
    """dW as nine f32 tap products over chunks of rows (the f32 path of
    ``wgrad_taps``): each chunk holds only (N, R + 2, W + 2, Cin) of x, and
    every product and the sum are f32, TF32 off. Returns (Cout, Cin, 3, 3)
    f32."""
    n, h, wd, cin = x.shape
    cout = g.shape[-1]
    r = _row_chunk(h)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(9, cin, cout, dtype=torch.float32, device=x.device)
    with precision.no_tf32():
        for j in range(h // r):
            # relu / leaky keep the zero padding zero
            rows = activation(xp[:, j * r:j * r + r + 2], pre_act).float()
            gc = g[:, j * r:(j + 1) * r].float().reshape(-1, cout)
            for ky in range(3):
                for kx in range(3):
                    xs = rows[:, ky:ky + r, kx:kx + wd].reshape(-1, cin)
                    acc[3 * ky + kx] += xs.t() @ gc
    return acc.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def wgrad3x3_ref(x, g, pre_act=None, dtype=torch.float32):
    """Plain version of the bf16 weight-gradient kernel (the CPU path and its
    gold): act(x) in x's dtype, every product and the sum over all pixels
    in f32 (TF32 off), rounded once to ``dtype``. x (N, H, W, Cin), g (N, H,
    W, Cout) NHWC; returns (Cout, Cin, 3, 3)."""
    n, h, wd, cin = x.shape
    cout = g.shape[-1]
    a = F.pad(activation(x, pre_act).float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(-1, cout)
    with precision.no_tf32():
        taps = [a[:, ky:ky + h, kx:kx + wd].reshape(-1, cin).t() @ gf
                for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, cout).permute(3, 2, 0, 1).to(dtype)


_WGRAD_BN = (16, 32, 48, 64)         # the N tiles wgrad3x3 is built for
_WGRAD_M = 64                        # channels of its M side a block
_WGRAD_TH, _WGRAD_TW = 16, 8         # a pixel tile: rows x columns
# the split model's costs: a block's walk over one pixel tile, the rate at
# which the f32 partials are written and read again, the adding kernel
_WGRAD_TILE_S, _WGRAD_PART_BPS, _WGRAD_SUM_S = 1e-6, 2.5e12, 4e-6


def wgrad3x3_tiles(cin: int, cout: int):
    """(x_on_m, bn) of the weight-gradient kernel for Cin -> Cout: which
    operand's channels take wgmma's M side (tiles of 64) and the N tile of
    the other's, the least time by a plain model: the padded product's size
    over its rate, the rate of an N tile of bn against shared memory's
    bandwidth min(1, 2 bn / (64 + bn)) of the peak; a tie goes to the wider
    tile, then to x on M. 128 -> 80: x on M, 48; 7 -> 128: g on M, 16."""
    def cost(xm, bn):
        m, n = (cin, cout) if xm else (cout, cin)
        rate = min(1.0, 2 * bn / (64 + bn))
        return (pad_to(m, _WGRAD_M) * pad_to(n, bn) / rate, -bn, not xm)
    return min(((xm, bn) for xm in (True, False) for bn in _WGRAD_BN),
               key=lambda c: cost(*c))


def wgrad3x3_splits(tiles: int, pixel_tiles: int, elems: int, sms: int,
                    room: int) -> int:
    """Blocks over the pixels of each of ``tiles`` output tiles: the least
    time, each wave of blocks over the card's ``sms`` taking as many pixel
    tiles as its blocks walk (``_WGRAD_TILE_S`` each), plus the f32 partials
    of ``elems`` outputs a split written and read again and the adding
    kernel's launch; at most ``pixel_tiles`` splits, partials of at most
    ``room`` bytes, and two waves of blocks at one tile."""
    most = max(1, min(pixel_tiles, 2 * sms, room // (4 * elems)))

    def cost(s):
        waves = -(-tiles * s // sms)
        walk = waves * -(-pixel_tiles // s) * _WGRAD_TILE_S
        return walk + (s > 1) * (s * elems * 8 / _WGRAD_PART_BPS + _WGRAD_SUM_S)
    return min(range(1, most + 1), key=cost)


@functools.lru_cache(maxsize=None)
def wgrad3x3_plan(n: int, h: int, w: int, cin: int, cout: int,
                  sms: int) -> dict:
    """How the weight-gradient kernel runs x (n, h, w, cin) against g (n, h,
    w, cout) on a card of ``sms`` SMs: ``x_on_m`` and ``bn``
    (``wgrad3x3_tiles``), its output ``tiles``, ``copies``, the bytes of
    the operands' zero-padded copies (7, 9 or 3 channels), and its
    ``splits`` over the pixels (``wgrad3x3_splits``; the f32 partials,
    splits x cout x cin x 9, exist where it is above 1): the partials take
    at most the bytes of the bf16 operands they are summed from."""
    xm, bn = wgrad3x3_tiles(cin, cout)
    m, nn = (cin, cout) if xm else (cout, cin)
    tiles = -(-m // _WGRAD_M) * -(-nn // bn)
    pixel_tiles = n * -(-h // _WGRAD_TH) * -(-w // _WGRAD_TW)
    copies = sum(2 * n * h * w * pad_to(c, 8) for c in (cin, cout) if c % 8)
    return dict(x_on_m=xm, bn=bn, tiles=tiles, copies=copies,
                splits=wgrad3x3_splits(tiles, pixel_tiles, cout * cin * 9, sms,
                                       2 * n * h * w * (cin + cout)))


def _declare_wgrad(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.wgrad3x3_bf16.argtypes = ([vp] * 4 + [i] * 10 + [ctypes.c_longlong]
                                  + [i] * 3 + [vp])
    lib.wgrad3x3_bf16.restype = ctypes.c_int


def wgrad3x3_launcher(x, g, pre_act=None, dtype=torch.bfloat16):
    """Check the arguments, copy an operand the kernel cannot read as it is
    (a pixel of 7, 9 or 3 channels: no multiple of 16 bytes; a view that is
    neither contiguous NHWC nor, for g, NCHW with contiguous channel planes,
    W % 8 == 0 and H % 2 == 0, which the kernel reads as it is) and allocate
    dW and the partial sums; return (launch, out): ``launch()`` is the bare
    kernel launch (two with the partials: the products, then their sum),
    and raises if it fails. CUDA bfloat16 tensors only; out is (Cout, Cin,
    3, 3) in ``dtype`` (bf16 or f32)."""
    if pre_act not in ACT_CODES:
        raise ValueError(pre_act)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wgrad3x3 writes float32/bfloat16, got {dtype}")
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"wgrad3x3: x {tuple(x.shape)} and g {tuple(g.shape)} "
                         f"are not NHWC of one (N, H, W)")
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"wgrad3x3 is a CUDA kernel: x on {x.device}, g on "
                         f"{g.device}")
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"wgrad3x3 takes bfloat16, got {x.dtype}, {g.dtype}")
    n, h, wd, cin = x.shape
    cout = g.shape[-1]

    def readable(t, c):
        if c % 8 == 0 and t.is_contiguous():
            return t
        wgrad3x3.copies += 1
        return F.pad(t, (0, pad_to(c, 8) - c)) if c % 8 else t.contiguous()
    # the gradient of a conv whose consumer's backward wrote NCHW (a
    # concatenation's slice among them): read as it is, a K-major operand
    sn, sh, sw, sc = g.stride()
    nchw = (not g.is_contiguous() and (sc, sh, sw) == (h * wd, wd, 1)
            and sn % 8 == 0 and wd % 8 == 0 and h % 2 == 0
            and g.data_ptr() % 16 == 0)
    xk = readable(x, cin)
    gk = g if nchw else readable(g, cout)
    cg = cout if nchw else gk.shape[-1]
    dev = x.device
    check_tensor("x", xk, (n, h, wd, xk.shape[-1]), torch.bfloat16, dev)
    if not nchw:
        check_tensor("g", gk, (n, h, wd, cg), torch.bfloat16, dev)
    plan = wgrad3x3_plan(n, h, wd, cin, cout, sm_count())
    splits = plan["splits"]
    lib = _build.load("wgrad3x3", _declare_wgrad)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((cout, cin, 3, 3), dtype=dtype, device=dev)
    part = (torch.empty((splits, cout, cin, 9), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    args = (xk.data_ptr(), gk.data_ptr(), 0 if part is None else part.data_ptr(),
            out.data_ptr(), n, h, wd, xk.shape[-1], cg, cin, cout, plan["bn"],
            int(plan["x_on_m"]), int(nchw), sn, splits, ACT_CODES[pre_act],
            int(dtype == torch.bfloat16), stream)

    def launch():
        err = lib.wgrad3x3_bf16(*args)
        if err != 0:
            raise RuntimeError(f"wgrad3x3 launch failed: cudaError {err}")
    launch.operands = (xk, gk, part)            # alive while launch may run
    launch.plan = dict(plan, g_nchw=nchw)
    return launch, out


def wgrad3x3(x, g, pre_act=None, dtype=torch.bfloat16):
    """The weight-gradient kernel (``csrc/wgrad3x3.cu``): dW of a 3x3/s1/p1
    conv from bf16 x (N, H, W, Cin) and g (N, H, W, Cout) on the card, bf16
    products on wgmma summed in f32, rounded once to ``dtype``; returns
    (Cout, Cin, 3, 3). CUDA tensors only (raises otherwise): the CPU's is
    ``wgrad3x3_ref``. ``wgrad3x3.launches`` counts calls (a counter that a
    replay adds to); ``wgrad3x3.copies`` the operands copied first, counted
    when a call is made."""
    launch, out = wgrad3x3_launcher(x, g, pre_act, dtype)
    launch()
    wgrad3x3.launches += 1
    return out


wgrad3x3.launches = 0
wgrad3x3.copies = 0


def wgrad_path(dtype, device) -> str:
    """Which weight gradient ``wgrad_taps`` takes for x and g of ``dtype``
    on ``device``: "kernel" (bf16 on the card: ``wgrad3x3``), "plain" (bf16
    elsewhere: ``wgrad3x3_ref``) or "rows" (any other dtype: the f32 tap
    products over row chunks, ``_wgrad_rows``; tensor cores would need TF32
    there, which the port forbids)."""
    if runs_kernel(dtype, device):
        return "kernel"
    return "plain" if dtype == torch.bfloat16 else "rows"


def wgrad_taps(x, g, pre_act=None, dtype=torch.float32):
    """dW of a 3x3/s1/p1 conv (JAX ``_wgrad_taps``): dW[co, ci, ky, kx] =
    sum over n, h, w of act(x)[n, h + ky - 1, w + kx - 1, ci] * g[n, h, w,
    co], zero outside; x (N, H, W, Cin) and g (N, H, W, Cout) NHWC. Returns
    (Cout, Cin, 3, 3) in ``dtype``, by ``wgrad_path``: bf16 on the card the
    kernel ``wgrad3x3`` (bf16 products, f32 sums, one rounding), bf16 on the
    CPU its plain version ``wgrad3x3_ref``, f32 the f32 tap products over
    chunks of rows. With tracing on its work (an operand's copy included)
    is the device span ``train.wgrad_taps``; ``wgrad_taps.launches`` counts
    its calls."""
    path = wgrad_path(x.dtype, x.device)
    wgrad_taps.launches += 1
    with profiling.device_span("train.wgrad_taps", x.device):
        if path == "kernel":
            return wgrad3x3(x, g, pre_act, dtype)
        if path == "plain":
            return wgrad3x3_ref(x, g, pre_act, dtype)
        return _wgrad_rows(x, g, pre_act).to(dtype)


# their calls: counters that a replay adds to (``core/graphs``)
wgrad_taps.launches = 0
graphs.register_counters(wgrad_taps, wgrad3x3)


class _Taps(torch.autograd.Function):
    """The library 3x3 conv with the tap-product weight gradient (JAX
    ``_conv3x3_taps``). x NCHW (channels_last); w OIHW in x's dtype; b in
    x's dtype or None. The backward returns the input gradient in x's
    memory format: in bf16 the library's dgrad issued with the saved x as
    its input, so a channels_last x gets cuDNN's NHWC dgrad (a g in another
    layout than x's is copied by the library once); in f32 the NCHW dgrad,
    its sums as before (a g that is not NCHW is copied to it), copied to a
    channels_last x's layout. ``conv3x3_taps.layout_copies`` counts those
    copies. The pre-activation's derivative and the bias gradient are one
    pass each."""

    @staticmethod
    def forward(ctx, x, w, b, pre_act):
        with precision.exact(x.dtype):
            y = F.conv2d(activation(x, pre_act), w, b, 1, 1)
        ctx.pre_act = pre_act
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pre_act = ctx.pre_act
        _TAPS_BACKWARDS.launches += 1
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            cl = torch.channels_last
            x_cl = x.is_contiguous(memory_format=cl)
            with precision.exact(g.dtype):
                if x.dtype == torch.float32:
                    # f32, the exact path, keeps the NCHW dgrad's order of
                    # sums (an NHWC one sums otherwise, and the f32 steps
                    # are held to their references at rounding level): g
                    # goes to NCHW, the result to x's layout
                    _TAPS_LAYOUT_COPIES.launches += (
                        (not g.is_contiguous()) + x_cl)
                    da = torch.nn.grad.conv2d_input(x.shape, w, g, padding=1)
                    if x_cl:
                        da = da.contiguous(memory_format=cl)
                else:
                    # the saved x as the input: the library's dgrad runs
                    # and returns in x's layout, with g copied to it first
                    # where g is laid out otherwise
                    _TAPS_LAYOUT_COPIES.launches += not g.is_contiguous(
                        memory_format=cl if x_cl else torch.contiguous_format)
                    da = torch.ops.aten.convolution_backward(
                        g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                        1, (True, False, False))[0]
            # da where x > 0, else da times the slope in da's dtype (0 for
            # relu, so a negative da gives -0): the product with the
            # rounded mask (JAX ``_taps_bwd``) in one pass
            if pre_act in ("relu", "leaky0.2"):
                slope = 0.0 if pre_act == "relu" else leaky_slope(da.dtype)
                da = torch.ops.aten.leaky_relu_backward(da, x, slope, False)
            elif pre_act is not None:
                raise ValueError(pre_act)
            gx = da.to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = wgrad_taps(x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1),
                            pre_act, w.dtype)
        if ctx.needs_input_grad[2]:
            gb = g.sum(dim=(0, 2, 3), dtype=torch.float32).to(w.dtype)
        return gx, gw, gb, None


def conv3x3_taps(x, w, b=None, pre_act=None):
    """pre_act -> 3x3/s1/p1 library conv (+ b) on NCHW x, whose weight
    gradient is ``wgrad_taps`` and input gradient the library's transposed
    conv in x's memory format (JAX ``_conv3x3_taps``). w and b in x's
    dtype. ``conv3x3_taps.backwards`` counts its backward calls and
    ``conv3x3_taps.layout_copies`` the copies their input gradients make to
    change a tensor's layout: bf16 one where g is laid out otherwise than x,
    f32 one where g is not NCHW and one where x is channels_last (counters
    that a replay adds to)."""
    return _Taps.apply(x, w, b, pre_act)


_TAPS_BACKWARDS, _TAPS_LAYOUT_COPIES = graphs.Count(), graphs.Count()
conv3x3_taps.backwards = _TAPS_BACKWARDS
conv3x3_taps.layout_copies = _TAPS_LAYOUT_COPIES
graphs.register_counters(_TAPS_BACKWARDS, _TAPS_LAYOUT_COPIES)


def kernel_for(x_shape, w_shape, stride, padding, dtype,
               device) -> Optional[Callable]:
    """The kernel wrapper whose gate admits this conv, or None. The
    small-channel gate is asked before the ``fast_conv`` gate, as in the JAX
    ``conv3x3``, and does not need ``fast_conv`` on."""
    if _views_eligible(x_shape, w_shape, stride, padding, dtype, device):
        return conv3x3_small
    if conv3x3_eligible(x_shape, w_shape, stride, padding, dtype, device):
        return conv3x3_wide
    return None


def conv3x3(x, w, bias=None, pre_act=None):
    """Fused pre_act -> 3x3/s1/p1 conv -> bias, in the JAX ``conv3x3``'s
    order: the kernel a gate admits, else under ``taps_wgrad`` (where a
    gradient is wanted) ``conv3x3_taps``, else on the CPU ``conv3x3_ref``.
    x: (N, H, W, Cin); w: (Cout, Cin, 3, 3); bias: (Cout,) or None;
    pre_act: None | 'relu' | 'leaky0.2', applied to x before the conv. A
    CUDA tensor that none of these takes raises: callers with a library
    path of their own ask ``kernel_for`` first."""
    run = kernel_for(x.shape, w.shape, (1, 1), (1, 1), x.dtype, x.device)
    if run is not None:
        return run(x, w, bias, pre_act)
    if _TAPS_WGRAD and torch.is_grad_enabled():
        # round, then add the bias, as conv3x3_ref and the JAX taps op
        y = conv3x3_taps(x.permute(0, 3, 1, 2), w.to(x.dtype), None,
                         pre_act).permute(0, 2, 3, 1)
        return y if bias is None else y + bias.to(x.dtype)
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, bias, pre_act)
    raise ValueError(
        f"conv3x3: no kernel gate admits x {tuple(x.shape)} {x.dtype} with w "
        f"{tuple(w.shape)} (fast_conv {'on' if _ENABLED else 'off'}, _VIEWS "
        f"{'on' if _VIEWS else 'off'})")

