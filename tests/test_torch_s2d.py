"""Space-to-depth ops: the port's ops/s2d.py vs the JAX package's, f32 on the
CPU, same numpy inputs; and the port's layers in the s2d domain vs their own
plain forward.

Layout ops must agree exactly. The convs and the norm sum up to 3*3*7 or
4*12*10 f32 values in another order on the two sides: 1e-5 absolute and
relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.ops import s2d as js
from hrviton_tpu_torch.nn import layers as tl
from hrviton_tpu_torch.ops import s2d as ts

torch.set_num_threads(1)
_rng = np.random.default_rng(7)


def _arr(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def _oihw(k):
    return _t(k).permute(3, 2, 0, 1)


def _close(got, want, exact=False):
    tol = 0 if exact else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def test_to_from_s2d():
    x = _arr(2, 8, 6, 5)
    _close(ts.to_s2d(_t(x)), js.to_s2d(jnp.asarray(x)), exact=True)
    _close(ts.from_s2d(ts.to_s2d(_t(x)), 5), x, exact=True)
    with pytest.raises(ValueError):
        ts.to_s2d(_t(_arr(1, 7, 6, 2)))
    with pytest.raises(ValueError):
        ts.from_s2d(_t(_arr(1, 4, 4, 10)), 3)


def test_upsample2x_and_concat():
    x = _arr(2, 4, 3, 5)
    _close(ts.upsample2x_s2d(_t(x)), js.upsample2x_s2d(jnp.asarray(x)), exact=True)
    up = np.repeat(np.repeat(x, 2, axis=1), 2, axis=2)
    _close(ts.from_s2d(ts.upsample2x_s2d(_t(x)), 5), up, exact=True)
    # the s2d form of the full-res concat: concat, then to_s2d
    a, b = _arr(2, 8, 6, 5), _arr(2, 8, 6, 3)
    got = ts.concat_s2d([ts.to_s2d(_t(a)), ts.to_s2d(_t(b))], [5, 3])
    want = js.concat_s2d([js.to_s2d(jnp.asarray(a)), js.to_s2d(jnp.asarray(b))],
                         [5, 3])
    _close(got, want, exact=True)
    _close(got, ts.to_s2d(torch.cat([_t(a), _t(b)], dim=-1)), exact=True)


@pytest.mark.parametrize("cin,cout,bias", [(7, 16, True), (5, 3, False)])
def test_conv3x3_s2d(cin, cout, bias):
    x, k = _arr(2, 16, 12, cin), _arr(3, 3, cin, cout) * 0.1
    b = _arr(cout) * 0.1 if bias else None
    want = js.conv3x3_s2d(js.to_s2d(jnp.asarray(x)), jnp.asarray(k),
                          None if b is None else jnp.asarray(b))
    got = ts.conv3x3_s2d(ts.to_s2d(_t(x)), _oihw(k), None if b is None else _t(b))
    _close(got, want)
    plain = torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2), _oihw(k),
                                       None if b is None else _t(b), 1, 1)
    _close(ts.from_s2d(got, cout), plain.permute(0, 2, 3, 1))


def test_conv3x3_s2d_boundary_rows_match_zero_padding():
    # an all-ones input exposes any padding-alignment error at the 4 edges
    x, k = np.ones((1, 8, 8, 3), np.float32), _arr(3, 3, 3, 2)
    want = js.conv3x3_s2d(js.to_s2d(jnp.asarray(x)), jnp.asarray(k))
    _close(ts.conv3x3_s2d(ts.to_s2d(_t(x)), _oihw(k)), want)


def test_conv1x1_s2d():
    x, k, b = _arr(2, 8, 6, 10), _arr(1, 1, 10, 4) * 0.1, _arr(4) * 0.1
    want = js.conv1x1_s2d(js.to_s2d(jnp.asarray(x)), jnp.asarray(k), jnp.asarray(b))
    _close(ts.conv1x1_s2d(ts.to_s2d(_t(x)), _oihw(k), _t(b)), want)


def test_instance_norm_s2d():
    x = _arr(2, 12, 10, 6) * 3.0 + 1.5
    want = js.instance_norm_s2d(js.to_s2d(jnp.asarray(x)), 6)
    got = ts.instance_norm_s2d(ts.to_s2d(_t(x)), 6)
    _close(got, want)
    plain = tl.instance_norm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(ts.from_s2d(got, 6), plain)


@pytest.mark.parametrize("layer,k,pad,bias", [
    ("conv", 3, 1, True), ("conv", 1, 0, False), ("spectral", 3, 1, True),
    ("spectral", 1, 0, False)])
def test_layers_in_the_s2d_domain(layer, k, pad, bias):
    """Conv2d / SpectralNorm2d(s2d=True) on a space-to-depth tensor give the
    s2d form of their plain forward, with the pre-activation, from the same
    parameters."""
    g = torch.Generator().manual_seed(0)
    cls = tl.Conv2d if layer == "conv" else tl.SpectralNorm2d
    m = cls(6, 5, k, padding=pad, bias=bias, init="normal", device="cpu")
    tl.init_weights(m, g)
    with torch.no_grad():
        m.weight.mul_(10.0)
        if bias:
            m.bias.copy_(torch.randn(5, generator=g) * 0.1)
    x = _t(_arr(2, 8, 6, 6))
    with torch.no_grad():
        plain = m(x.permute(0, 3, 1, 2), pre_act="leaky0.2").permute(0, 2, 3, 1)
        got = m(ts.to_s2d(x).permute(0, 3, 1, 2), pre_act="leaky0.2", s2d=True)
    _close(ts.from_s2d(got.permute(0, 2, 3, 1), 5), plain)
    with pytest.raises(NotImplementedError):
        tl.conv_forward(x.permute(0, 3, 1, 2), torch.zeros(5, 6, 3, 3), None, 2, 1,
                        s2d_domain=True)
