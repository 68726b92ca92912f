"""Port ops vs the JAX package, f32 on the CPU, same numpy inputs.

Tolerances: resize, grid_sample and the LUT are a few f32 multiply-adds per
output (1e-5 absolute); the blur sums 15+15 taps in another order than the
JAX banded matmul (1e-5).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu_torch.ops import blur, parse, resize

# the JAX ops package re-exports functions under its module names
jblur, jgs, jparse, jresize, gs = (importlib.import_module(m) for m in (
    "hrviton_tpu.ops.blur", "hrviton_tpu.ops.grid_sample",
    "hrviton_tpu.ops.parse", "hrviton_tpu.ops.resize",
    "hrviton_tpu_torch.ops.grid_sample"))

torch.set_num_threads(1)
_rng = np.random.default_rng(0)


def _both(shape, scale=1.0):
    a = (_rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("size,sf,mode,ac", [
    ((16, 12), None, "bilinear", False),      # downscale, integer ratio
    ((40, 30), None, "bilinear", False),      # upscale, non-integer
    ((40, 30), None, "bilinear", True),
    (None, 2, "bilinear", False),
    ((16, 12), None, "nearest", False),
    (None, 2, "nearest", False),
    ((20, 9), None, "nearest", False),        # non-integer ratio
])
def test_interpolate(size, sf, mode, ac):
    j, t = _both((2, 32, 24, 3))
    want = jresize.interpolate(j, size=size, scale_factor=sf, mode=mode,
                               align_corners=ac)
    got = resize.interpolate(t, size=size, scale_factor=sf, mode=mode,
                             align_corners=ac)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_resize_flow():
    j, t = _both((2, 8, 6, 2), 3.0)
    _close(resize.resize_flow(t, (32, 24)), jresize.resize_flow(j, (32, 24)),
           atol=1e-4)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample(padding_mode):
    jx, tx = _both((2, 10, 12, 5))
    jg, tg = _both((2, 7, 9, 2), 0.8)          # includes out-of-range coords
    _close(gs.grid_sample(tx, tg, padding_mode),
           jgs.grid_sample(jx, jg, padding_mode))


def test_make_grid_and_flow_warp():
    # linspace points: the two libraries differ by up to 1 ulp
    _close(gs.make_grid(2, 7, 5), jgs.make_grid(2, 7, 5), atol=2e-7, rtol=0)
    jx, tx = _both((2, 16, 12, 3))
    jf, tf = _both((2, 16, 12, 2), 2.0)
    _close(gs.flow_warp(tx, tf, 5.5, 7.5), jgs.flow_warp(jx, jf, 5.5, 7.5))


def test_gaussian_blur():
    j, t = _both((2, 40, 30, 13), 4.0)
    np.testing.assert_array_equal(blur.gaussian_kernel1d(15, 3.0),
                                  jblur.gaussian_kernel1d(15, 3.0))
    _close(blur.gaussian_blur(t, (15, 15), (3.0, 3.0)),
           jblur.gaussian_blur(j, (15, 15), (3.0, 3.0)), atol=1e-5)


def test_parse_lut_and_onehot():
    np.testing.assert_array_equal(parse.group_index_of_label13(),
                                  jparse.group_index_of_label13())
    labels = _rng.integers(0, 13, (2, 9, 7)).astype(np.int32)
    lut = parse.lut_lookup(torch.from_numpy(labels),
                           parse.group_index_of_label13())
    want = jparse.lut_lookup(jnp.asarray(labels),
                             jparse.group_index_of_label13())
    np.testing.assert_array_equal(lut.numpy(), np.asarray(want))
    np.testing.assert_array_equal(parse.onehot(lut, 7).numpy(),
                                  np.asarray(jparse.onehot(want, 7)))
