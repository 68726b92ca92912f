"""Fused [pre-activation ->] 3x3 stride-1 pad-1 conv [-> bias].

PyTorch counterpart of ``hrviton_tpu/ops/conv3x3.py``. Two hand-written CUDA
kernels for sm_90a (``csrc/conv3x3.cu``) stand where the JAX package has two
Pallas kernels:

  * ``conv3x3_wide``: wide channel counts (the JAX ``_conv3x3_pallas``). The
    bias joins the f32 accumulator and the sum is rounded once. In bf16 it
    runs on the TMA / wgmma conv engine (``csrc/conv_engine.cuh``), with its
    weights packed once per weight tensor (``ops/conv_engine.py``).
  * ``conv3x3_small``: small channel counts, 3 * Cin <= 128 and 3 * Cout <=
    128 (the JAX ``_conv3x3_views_pallas``). The accumulator is rounded,
    then the bias is added in the output dtype. In bf16 it runs on the same
    engine, in N tiles of 8, 16 or 32 columns; a Cin below 15 that is no
    multiple of 8 (9 channels: 18-byte pixels) is read as rows of W * Cin
    elements (``narrow_box``), a larger one from a copy of x with its
    channels zero-padded to a multiple of 8 (``small_channels``).

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version ``conv3x3_ref``, with its own rounding chain, only for a CPU
tensor. ``conv3x3`` sends a call to the kernel its gate admits, as the JAX
``conv3x3`` does: the small-channel gate (``_views_eligible``, under the
module switch ``_VIEWS``) is asked first, then ``conv3x3_eligible`` (under
``fast_conv``). The layers ask the same gates through ``kernel_for`` and keep
their library convolution where neither admits the call. The backward pieces
of the JAX module are not ported yet.

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

from hrviton_tpu_torch.core import precision
from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.ops._build import (ACT_CODES, KERNEL_DTYPES,
                                          check_tensor, pad_to)
from hrviton_tpu_torch.ops.conv_engine import pack_kmajor, packed, pick_bn

__all__ = ["conv3x3", "conv3x3_wide", "conv3x3_small", "conv3x3_ref",
           "conv3x3_eligible", "kernel_for", "enable_fast_conv",
           "fast_conv_enabled", "fast_conv", "activation", "leaky_slope",
           "small_tiles", "small_weights", "narrow_box", "small_channels",
           "small_launcher",
           "conv_flops", "conv_bytes"]

_TH = 8          # the JAX kernels' rows per grid step: their gates' row rule
_WIDE_BN = (32, 64, 96, 128, 136)   # the N tiles conv3x3_wide is built for
_SMALL_BN = (8, 16, 32)             # and conv3x3_small
_HALO_COLS = 34  # columns of the engine's halo tile that its products read
_ENABLED = False
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


def _on_card(dtype, device) -> bool:
    """A CUDA device and bfloat16: the JAX gates take bf16 only, so an f32
    conv stays the library's and the f32 kernels are reached by a direct
    call of their wrappers alone."""
    return torch.device(device).type == "cuda" and dtype == torch.bfloat16


def conv3x3_eligible(x_shape, w_shape, stride, padding, dtype, device) -> bool:
    """Gate of the wide kernel: ``fast_conv`` on, and the JAX gate's shape
    rules (h % 8 == 0, w % 8 == 0, h > 8, h >= 128, w >= 96, Cin % 128 == 0)
    on a CUDA device in bfloat16. Always false on the CPU."""
    if not _ENABLED or not _is_3x3_s1_p1(w_shape, stride, padding):
        return False
    _, h, w, cin = x_shape
    if not (h % _TH == 0 and w % 8 == 0 and h > _TH):
        return False
    return (_on_card(dtype, device) and h >= 128 and w >= 96
            and cin % 128 == 0)


def _views_eligible(x_shape, w_shape, stride, padding, dtype, device) -> bool:
    """Gate of the small-channel kernel: ``_VIEWS`` on, and the JAX gate's
    shape rules (h % 8 == 0, w % 128 == 0, h > 8, h >= 512, 3 * Cin <= 128,
    3 * Cout <= 128) on a CUDA device in bfloat16."""
    if not _VIEWS or not _is_3x3_s1_p1(w_shape, stride, padding):
        return False
    _, h, w, cin = x_shape
    if not (h % _TH == 0 and w % 128 == 0 and h > _TH):
        return False
    return (_on_card(dtype, device) and w_shape[0] * 3 <= 128
            and cin * 3 <= 128 and h >= 512)


def conv3x3_ref(x, w, bias=None, pre_act=None, fused_bias: bool = False):
    """Plain PyTorch version (the CPU path and the gold of both kernels).

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
    lib.conv3x3_forward_f32.argtypes = [vp] * 4 + [i] * 8 + [vp]
    lib.conv3x3_forward_f32.restype = ctypes.c_int


def _taps(w, dtype, cinp: int, np_: int):
    """(Cout, Cin, 3, 3) -> (9, cinp, np_) in ``dtype``, K x N per tap, zero
    padded."""
    cout, cin = w.shape[0], w.shape[1]
    k = w.to(dtype).permute(2, 3, 1, 0).reshape(9, cin, cout)
    return F.pad(k, (0, np_ - cout, 0, cinp - cin))


def wide_weights(w, bias, bn: int):
    """The wide bf16 kernel's operands for N tiles of ``bn``: the taps in the
    engine's layout, (CINP / 16, NP / bn, 9, bn, 16), and the bias rounded
    through bf16, f32, zero-padded to NP; packed once per (w, bias)."""
    def make():
        cout, cin = w.shape[0], w.shape[1]
        wk = pack_kmajor(w.permute(2, 3, 1, 0).reshape(9, cin, cout), bn)
        return wk, _bias_f32(bias, torch.bfloat16, wk.shape[1] * bn, w.device)
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
        return wk, _bias_f32(bias, torch.bfloat16, wk.shape[1] * bn, w.device)
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


def _bias_f32(bias, dtype, np_: int, device):
    """The bias as the kernels take it: rounded through ``dtype``, f32, zero
    padded to ``np_`` (zeros for no bias)."""
    if bias is None:
        return torch.zeros(np_, dtype=torch.float32, device=device)
    return F.pad(bias.to(dtype).float(), (0, np_ - bias.shape[0])).contiguous()


def _launcher(kind: str, x, w, bias, pre_act):
    """Check the arguments, pack the weights and allocate the output; return
    (launch, out): ``launch()`` makes the one kernel launch into ``out`` and
    nothing else, and raises if it fails. CUDA tensors only."""
    if pre_act not in ACT_CODES:
        raise ValueError(pre_act)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"conv3x3 kernels take float32/bfloat16, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} (NHWC) does not go with "
                         f"w {tuple(w.shape)} (Cout, Cin, 3, 3)")
    n, h, ww, cin = x.shape
    cout = w.shape[0]
    dev = x.device
    check_tensor("x", x, (n, h, ww, cin), x.dtype, dev)
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected ({cout},)")
    if w.device != dev:
        raise ValueError(f"w on {w.device}, expected {dev}")
    small = kind == "small"
    bf16 = x.dtype == torch.bfloat16
    if small and (cin * 3 > 128 or cout * 3 > 128):
        raise ValueError(f"conv3x3_small takes 3 * Cin <= 128 and 3 * Cout <= "
                         f"128, got {cin} -> {cout}")
    box, xk = 0, x
    if bf16 and cin % 8:
        if not small:
            raise ValueError(f"conv3x3_wide takes Cin % 8 == 0 in bfloat16, got {cin}")
        if small_channels(cin) != cin:
            xk = F.pad(x, (0, small_channels(cin) - cin))
        elif ww * cin % 8:
            raise ValueError(f"conv3x3_small takes, in bfloat16, a Cin below 15 "
                             f"with W * Cin % 8 == 0; got Cin {cin}, W {ww}")
        else:
            box = narrow_box(cin)
    lib = _build.load("conv3x3", _declare)
    out = torch.empty((n, h, ww, cout), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    act = ACT_CODES[pre_act]
    if not bf16:
        cinp, np_ = pad_to(cin, 32), pad_to(cout, 32)
        wk = _taps(w, x.dtype, cinp, np_).contiguous()
        bk = _bias_f32(bias, x.dtype, np_, dev)
        fn = lib.conv3x3_forward_f32
        args = (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                n, h, ww, cin, cout, cinp, np_, act, stream)
    elif small:
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
    the kernel alone). CUDA tensors only."""
    return _launcher("small", x, w, bias, pre_act)


def _run(wrapper, kind: str, fused_bias: bool, x, w, bias, pre_act):
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, bias, pre_act, fused_bias=fused_bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_{kind}: unsupported device {x.device}")
    launch, out = _launcher(kind, x, w, bias, pre_act)
    launch()
    wrapper.launches += 1
    return out


def conv3x3_wide(x, w, bias=None, pre_act=None):
    """The wide kernel: pre_act -> 3x3/s1/p1 conv -> + bias in f32 -> one
    round. x: (N, H, W, Cin) contiguous; w: (Cout, Cin, 3, 3); bias: (Cout,)
    or None. CUDA tensors launch the kernel (or raise; bfloat16 needs Cin %
    8 == 0); CPU tensors take ``conv3x3_ref`` with ``fused_bias=True``.
    ``conv3x3_wide.launches`` counts kernel launches."""
    return _run(conv3x3_wide, "wide", True, x, w, bias, pre_act)


def conv3x3_small(x, w, bias=None, pre_act=None):
    """The small-channel kernel: pre_act -> 3x3/s1/p1 conv -> round -> + bias
    in the output dtype, for 3 * Cin <= 128 and 3 * Cout <= 128. Arguments as
    ``conv3x3_wide``. CUDA tensors launch the kernel (or raise; in bfloat16
    a Cin below 15 that is no multiple of 8 needs W * Cin % 8 == 0, and a
    Cin from 15 to 42 that is none is read from a zero-padded copy of x);
    CPU tensors take ``conv3x3_ref``. ``conv3x3_small.launches`` counts kernel launches."""
    return _run(conv3x3_small, "small", False, x, w, bias, pre_act)


conv3x3_wide.launches = 0
conv3x3_small.launches = 0


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
    """Fused pre_act -> 3x3/s1/p1 conv -> bias through the kernel its gate
    admits. x: (N, H, W, Cin); w: (Cout, Cin, 3, 3); bias: (Cout,) or None;
    pre_act: None | 'relu' | 'leaky0.2', applied to x before the conv.

    A CPU tensor takes ``conv3x3_ref`` (no gate admits it). A CUDA tensor
    that no gate admits raises: callers with a library path of their own ask
    ``kernel_for`` first."""
    run = kernel_for(x.shape, w.shape, (1, 1), (1, 1), x.dtype, x.device)
    if run is not None:
        return run(x, w, bias, pre_act)
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, bias, pre_act)
    raise ValueError(
        f"conv3x3: no kernel gate admits x {tuple(x.shape)} {x.dtype} with w "
        f"{tuple(w.shape)} (fast_conv {'on' if _ENABLED else 'off'}, _VIEWS "
        f"{'on' if _VIEWS else 'off'})")


def conv_flops(b, h, w, cin, cout) -> int:
    """Operations of one 3x3 conv (2 per multiply-add)."""
    return 2 * b * h * w * 9 * cin * cout


def conv_bytes(b, h, w, cin, cout, elem=2) -> int:
    """Bytes the conv must move: x read once, out written once, weights and
    bias read once."""
    return (b * h * w * (cin + cout) + 9 * cin * cout + cout) * elem
