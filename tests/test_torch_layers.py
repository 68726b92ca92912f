"""Port layers vs the JAX package's Flax layers, f32 on the CPU.

Each JAX layer is initialised, its variables perturbed (random biases,
BatchNorm running stats, spectral u/v) and carried into the port with
``load_jax_variables``. Tolerance 1e-5 absolute / 1e-4 relative: a conv
sums at most 3*3*16 f32 products, in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.nn import layers as jl
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.nn import layers as tl

torch.set_num_threads(1)
_rng = np.random.default_rng(1)


def _rand_like_tree(tree, scale=0.3, positive=()):
    """Replace every leaf with random values (|x| for names in positive)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _rand_like_tree(v, scale, positive)
        else:
            a = _rng.standard_normal(np.shape(v)).astype(np.float32) * scale
            out[k] = np.abs(a) + 0.5 if k in positive else a
    return out


def _x(shape):
    a = _rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a).permute(0, 3, 1, 2)


def _close(t_nchw, j_nhwc, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(t_nchw.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(j_nhwc), atol=atol, rtol=rtol)


@pytest.mark.parametrize("k,stride,pad,bias,pre_act", [
    (3, 1, 1, True, None), (3, 2, 1, False, None), (1, 1, 0, True, "relu"),
    (3, 1, 1, True, "leaky0.2")])
def test_conv2d(k, stride, pad, bias, pre_act):
    jx, tx = _x((2, 11, 9, 6))
    m = jl.Conv2d(5, k, stride=stride, padding=pad, use_bias=bias)
    v = _rand_like_tree(m.init(jax.random.PRNGKey(0), jx))
    want = m.apply(v, jx, pre_act=pre_act)
    port = tl.Conv2d(6, 5, k, stride, pad, bias, device="cpu")
    load_jax_variables(port, v)
    _close(port(tx, pre_act=pre_act), want)


def test_batchnorm_eval_running_stats():
    jx, tx = _x((3, 6, 5, 4))
    m = jl.BatchNorm2d(4)
    v = m.init(jax.random.PRNGKey(0), jx, use_running_average=True)
    v = {"params": _rand_like_tree(v["params"]),
         "batch_stats": _rand_like_tree(v["batch_stats"], positive=("var",))}
    want = m.apply(v, jx, use_running_average=True)
    port = tl.BatchNorm2d(4, device="cpu")
    load_jax_variables(port, v)
    _close(port(tx), want)


def test_instancenorm():
    jx, tx = _x((2, 7, 6, 3))
    want = jl.InstanceNorm2d().apply({}, jx * 3 + 1)
    _close(tl.InstanceNorm2d()(tx * 3 + 1), want)


@pytest.mark.parametrize("k,pad,bias", [(3, 1, True), (1, 0, False)])
def test_spectralnorm_eval(k, pad, bias):
    jx, tx = _x((2, 8, 7, 6))
    m = jl.SpectralNorm2d(4, k, padding=pad, use_bias=bias)
    v = m.init(jax.random.PRNGKey(0), jx)
    v = {"params": _rand_like_tree(v["params"]),
         "aux": _rand_like_tree(v["aux"], 1.0)}       # random u, v
    want = m.apply(v, jx, update_stats=False, pre_act="leaky0.2")
    port = tl.SpectralNorm2d(6, 4, k, padding=pad, bias=bias, device="cpu")
    load_jax_variables(port, v)
    _close(port(tx, pre_act="leaky0.2"), want, atol=1e-4)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.Conv2d(3, 4, 3)
