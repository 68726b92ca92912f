"""Gradients of the four model-path kernels' autograd.Functions against the
JAX custom VJPs, on the CPU: the JAX ``spade_conv_unit``,
``fused_spade_modulate``, ``_conv3x3_cvjp`` and ``_conv3x3_views_cvjp``,
their Pallas forwards in interpret mode, through ``jax.vjp``; the port's
wrappers (plain forward on the CPU, backward autograd of the plain version)
through ``torch.autograd.grad``, on the same numpy inputs and output
cotangent. Also the im2col-free weight gradient (``wgrad_taps``) and the
taps op against the JAX ``_wgrad_taps`` / ``_conv3x3_taps``, and the
dispatch of a library 3x3 conv under ``taps_wgrad``.

Limits: f32 every gradient within 1e-4 x its max|ref|; bf16 (inputs, weights
and cotangent in bf16 on both sides) within 2 bf16 ulps of max|ref| beyond
the JAX gradient's own bf16 error (its distance from the f32 gradient of
the same bf16-rounded inputs): the two frameworks round the elementwise
chains of the backward at different points, and the instance norm's
backward (a difference of means) magnifies those roundings: the unit's x
gradient differs by up to 15 ulps of max|ref| between the two sides here.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hrviton_tpu_torch.nn import layers as tlayers
from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.ops import spade_block as tsb
from hrviton_tpu_torch.ops import spade_fused as tsf

sb = importlib.import_module("hrviton_tpu.ops.spade_block")
sf = importlib.import_module("hrviton_tpu.ops.spade_fused")
c3 = importlib.import_module("hrviton_tpu.ops.conv3x3")
torch.set_num_threads(1)
_rng = np.random.default_rng(0)
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _interpret_small_tiles(monkeypatch):
    for mod in (sb, sf, c3):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setattr(sb, "_TH", 4)
    monkeypatch.setattr(sf, "_TH", 4)
    monkeypatch.setattr(c3, "_TH", 4)
    monkeypatch.setattr(c3, "_VTH", 4)


def _a(shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


def _to_torch(a, dtype, oihw=False):
    if a is None:
        return None
    t = torch.from_numpy(a)
    if oihw:
        t = t.permute(3, 2, 0, 1)
    return t.to(dtype).detach().requires_grad_(True)


def _to_jax(a, dtype):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _check(got, want, dtype, label="", exact=None):
    """f32: within 1e-4 x max|ref|. bf16: within 2 bf16 ulps of max|ref|
    beyond the reference's own bf16 error, |ref - exact|, ``exact`` the JAX
    gradient in f32 of the same bf16-rounded inputs and cotangent."""
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, (label, i)
            continue
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        a = a.float().numpy()
        if a.ndim == 4 and b.ndim == 4 and a.shape != b.shape:
            a = a.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
        scale = float(np.abs(b).max())
        lim = (1e-4 if dtype == "f32" else 2 * BF16_ULP) * scale
        if exact is not None:
            lim += float(np.abs(b - np.asarray(exact[i], np.float32)).max())
        assert np.isfinite(a).all(), (label, i)
        assert float(np.abs(a - b).max()) <= lim, (label, i, np.abs(a - b).max(), lim)


_DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _vjp_both(jfn, tfn, arrays, oihw, dtype, out_shape):
    """(port gradients, JAX gradients, the JAX f32 gradients of the
    bf16-rounded inputs in bf16, else None)."""
    td, jd = _DT[dtype]
    g = _a(out_shape)
    idx = [i for i, a in enumerate(arrays) if a is not None]

    def jvjp(d):
        jargs = [_to_jax(a, d) for a in arrays]
        out, vjp = jax.vjp(lambda *v: jfn(*[v[idx.index(i)] if i in idx else None
                                            for i in range(len(arrays))]),
                           *[jargs[i] for i in idx])
        return vjp(jnp.asarray(g).astype(d).astype(out.dtype))

    want = jvjp(jd)
    exact = None
    if dtype == "bf16":
        rounded = [None if a is None else
                   np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                   for a in arrays]
        arrays_f32, arrays[:] = list(arrays), rounded
        g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
        exact = jvjp(jnp.float32)
        arrays[:] = arrays_f32
    targs = [_to_torch(a, td, i in oihw) for i, a in enumerate(arrays)]
    tout = tfn(*targs)
    got = torch.autograd.grad(tout, [targs[i] for i in idx],
                              torch.from_numpy(g).to(tout.dtype))
    return got, want, exact


# --------------------------------------------------------------- the unit

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ksize,pre_act,residual,bias", [
    (3, "leaky0.2", False, True), (3, "leaky0.2", True, True),
    (1, None, False, False), (1, "relu", True, False)])
def test_unit_grads_match_jax_vjp(ksize, pre_act, residual, bias, dtype):
    b, h, w, c, cout, nh = 2, 8, 128, 8, 16, 128
    arrays = [_a((b, h, w, c)), _a((b, h, w, 1)), _a((c,), 0.3),
              _a((b, h, w, nh)), _a((3, 3, nh, c), 0.05), _a((c,), 0.1),
              _a((3, 3, nh, c), 0.05), _a((c,), 0.1),
              _a((ksize, ksize, c, cout), 0.1), _a((cout,), 0.1) if bias else None,
              _a((b, h, w, cout)) if residual else None]
    before = tsb.spade_conv_unit.launches
    got, want, exact = _vjp_both(
        lambda *a: sb.spade_conv_unit(pre_act, *a),
        lambda *a: tsb.spade_conv_unit(pre_act, *a),
        arrays, {4, 6, 8}, dtype, (b, h, w, cout))
    assert tsb.spade_conv_unit.launches == before        # no kernel on the CPU
    _check(got, want, dtype, "unit", exact)


# --------------------------------------------------------- the modulation

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,h,w", [(8, 16, 16), (40, 16, 16)])
def test_modulate_grads_match_jax_vjp(c, h, w, dtype):
    b, nh = 2, 128
    arrays = [_a((b, h, w, c)), _a((b, h, w, 1)), _a((c,), 0.3),
              _a((b, h, w, nh)), _a((3, 3, nh, c), 0.05), _a((c,), 0.1),
              _a((3, 3, nh, c), 0.05), _a((c,), 0.1)]
    with sf.fast_spade(True):
        got, want, exact = _vjp_both(sf.fused_spade_modulate, tsf.fused_spade_modulate,
                              arrays, {4, 6}, dtype, (b, h, w, c))
    _check(got, want, dtype, "modulate", exact)


# ------------------------------------------------------- the 3x3 convs

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
@pytest.mark.parametrize("bias", [True, False])
def test_wide_conv_grads_match_jax_vjp(pre_act, bias, dtype):
    x, w = _a((2, 16, 24, 128)), _a((3, 3, 128, 12), 0.05)
    b = _a((12,), 0.1) if bias else None
    with c3.fast_conv(True):
        got, want, exact = _vjp_both(
            lambda x_, w_, b_: c3._conv3x3_cvjp(x_, w_, b_, pre_act, bias),
            lambda x_, w_, b_: tc3.conv3x3_wide(x_, w_, b_, pre_act),
            [x, w, b], {1}, dtype, (2, 16, 24, 12))
    _check(got, want, dtype, "wide", exact)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,pre_act", [(9, 16, None), (32, 3, "leaky0.2"),
                                              (32, 32, "leaky0.2")])
def test_small_conv_grads_match_jax_vjp(cin, cout, pre_act, dtype):
    x, w, b = _a((2, 8, 128, cin)), _a((3, 3, cin, cout), 0.05), _a((cout,), 0.1)
    got, want, exact = _vjp_both(
        lambda x_, w_, b_: c3._conv3x3_views_cvjp(x_, w_, b_, pre_act, True),
        lambda x_, w_, b_: tc3.conv3x3_small(x_, w_, b_, pre_act),
        [x, w, b], {1}, dtype, (2, 8, 128, cout))
    _check(got, want, dtype, "small", exact)


# ----------------------------------------------- the tap-product wgrad

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("h", [16, 12, 7])
@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
def test_wgrad_taps_matches_jax(pre_act, h, dtype):
    """h = 16 and 12 take row chunks of 8 and 4; h = 7 one chunk."""
    td, jd = _DT[dtype]
    x, g = _a((2, h, 10, 6)), _a((2, h, 10, 5))
    want = c3._wgrad_taps(jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd),
                          pre_act)
    got = tc3.wgrad_taps(torch.from_numpy(x).to(td), torch.from_numpy(g).to(td),
                         pre_act)
    assert got.dtype == torch.float32
    _check([got], [want], "f32", "wgrad_taps")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pre_act", [None, "leaky0.2"])
def test_taps_op_matches_jax_vjp(pre_act, dtype):
    x, w, b = _a((2, 16, 12, 8)), _a((3, 3, 8, 6), 0.1), _a((6,), 0.1)
    with tc3.taps_wgrad(True):
        got, want, exact = _vjp_both(
            lambda x_, w_, b_: c3._conv3x3_taps(x_, w_, b_, pre_act, True),
            lambda x_, w_, b_: tc3.conv3x3(x_, w_, b_, pre_act),
            [x, w, b], {1}, dtype, (2, 16, 12, 6))
    _check(got, want, dtype, "taps", exact)


def test_taps_dispatch(monkeypatch):
    """Under taps_wgrad a library 3x3 conv that needs a gradient takes the
    tap-product op with the library's forward (bit for bit); without a
    gradient, or with the switch off, the library conv."""
    calls = []
    real = tc3.conv3x3_taps
    monkeypatch.setattr(tc3, "conv3x3_taps",
                        lambda *a: calls.append(1) or real(*a))
    conv = tlayers.Conv2d(8, 4, 3, padding=1, device="cpu")
    tlayers.init_weights(conv, torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 10, 12).contiguous(memory_format=torch.channels_last)
    plain = conv(x, pre_act="relu")
    assert not calls
    with tc3.taps_wgrad(True):
        with torch.no_grad():
            conv(x)
        assert not calls
        y = conv(x, pre_act="relu")
    assert calls == [1]
    assert torch.equal(y, plain)
    y.square().sum().backward()
    wgrad = conv.weight.grad.clone()
    conv.weight.grad = None
    conv(x, pre_act="relu").square().sum().backward()
    torch.testing.assert_close(wgrad, conv.weight.grad, atol=1e-5, rtol=1e-5)
    assert not tc3.taps_wgrad_enabled()


def test_dispatch_order_views_wide_taps(monkeypatch):
    """The JAX conv3x3's order: the small-channel gate first, then the wide
    gate, then taps, then the library."""
    asked = []
    monkeypatch.setattr(tc3, "kernel_for", lambda *a: asked.append("gates") or None)
    x = torch.randn(1, 8, 8, 4, requires_grad=True)
    w = torch.randn(4, 4, 3, 3, requires_grad=True)
    with tc3.taps_wgrad(True):
        tc3.conv3x3(x, w)
    assert asked == ["gates"]
