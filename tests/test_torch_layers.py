"""Port layers vs the JAX package's Flax layers, f32 on the CPU.

Each JAX layer is initialised, its variables perturbed (random biases,
BatchNorm running stats, spectral u/v) and carried into the port with
``load_jax_variables``. Tolerance 1e-5 absolute / 1e-4 relative: a conv
sums at most 3*3*16 f32 products, in another order on each side.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


@pytest.mark.parametrize("kind", ["leaky0.2", "relu"])
def test_activation_bf16_is_bit_equal(kind):
    """bf16: the JAX package multiplies by the slope rounded to bf16
    (jax.nn.leaky_relu in nn/layers.py, max(x, 0.2x) in ops/conv3x3.py and
    ops/spade_block.py); so must the port. Exact, on the same bf16 inputs.
    float32 keeps float32(0.2)."""
    jc3 = importlib.import_module("hrviton_tpu.ops.conv3x3")
    a = (_rng.standard_normal(50000) * 3).astype(np.float32)
    a[:4] = [0.0, -0.0, 1.0, -1.0]
    xb = jnp.asarray(a).astype(jnp.bfloat16)
    got = tl.activation(torch.from_numpy(a).bfloat16(), kind)
    assert got.dtype == torch.bfloat16
    wants = [jc3._act(xb, kind)]
    if kind == "leaky0.2":
        wants.append(jl.leaky_relu(xb, 0.2))
    for want in wants:
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    xf = torch.from_numpy(a)
    torch.testing.assert_close(
        tl.activation(xf, kind),
        F.leaky_relu(xf, 0.2) if kind == "leaky0.2" else F.relu(xf),
        atol=0, rtol=0)
    np.testing.assert_array_equal(tl.activation(xf, kind).numpy(),
                                  np.asarray(jc3._act(jnp.asarray(a), kind)))


def test_conv2d_routes_3x3_through_the_kernel_gate(monkeypatch):
    """A 3x3/s1/p1 conv asks ops/conv3x3.kernel_for and, when a gate admits
    it, hands the wrapper a contiguous NHWC tensor with the pre-activation
    still to do; the result comes back as a channels_last view. Other convs
    never ask."""
    asked = []

    def kernel_for(x_shape, w_shape, stride, padding, dtype, device):
        asked.append((tuple(x_shape), tuple(w_shape)))

        def run(x, w, bias, pre_act):
            assert x.is_contiguous() and pre_act == "relu"
            return tl.c3.conv3x3_ref(x, w, bias, pre_act)
        return run

    g = torch.Generator().manual_seed(0)
    m3 = tl.Conv2d(6, 5, 3, padding=1, device="cpu")
    m1 = tl.Conv2d(6, 5, 1, device="cpu")
    ms = tl.Conv2d(6, 5, 3, stride=2, padding=1, device="cpu")
    for m in (m3, m1, ms):
        tl.init_weights(m, g)
    x = torch.randn(2, 6, 9, 7, generator=g)               # NCHW, not channels_last
    with torch.no_grad():
        want = [m(x, pre_act="relu") for m in (m3, m1, ms)]
        monkeypatch.setattr(tl.c3, "kernel_for", kernel_for)
        got = [m(x, pre_act="relu") for m in (m3, m1, ms)]
    assert asked == [((2, 9, 7, 6), (5, 6, 3, 3))]
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


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


# ------------------------------------------------------------ training modes

def test_batchnorm_train_output_stats_and_grads():
    """Training mode: the batch's statistics normalize (biased two-pass
    variance), the running mean and unbiased variance are staged with
    momentum 0.1 and written by commit_state; the input and affine
    gradients match jax.grad."""
    jx, tx = _x((3, 6, 5, 4))
    jx, tx = jx * 2 + 0.5, tx * 2 + 0.5
    m = jl.BatchNorm2d(4)
    v = m.init(jax.random.PRNGKey(0), jx, use_running_average=True)
    v = {"params": _rand_like_tree(v["params"]),
         "batch_stats": _rand_like_tree(v["batch_stats"], positive=("var",))}
    r = _rng.standard_normal((3, 6, 5, 4)).astype(np.float32)

    def f(params, x):
        y, new = m.apply({"params": params, "batch_stats": v["batch_stats"]},
                         x, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y) * r), (y, new)

    (_, (want, new)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                                    has_aux=True)(v["params"], jx)
    port = tl.BatchNorm2d(4, device="cpu")
    load_jax_variables(port, v)
    xt = tx.clone().requires_grad_(True)
    y = port(xt, train=True)
    _close(y, want)
    stats = (port.running_mean.clone(), port.running_var.clone())
    torch.testing.assert_close(stats[0], torch.from_numpy(
        np.asarray(v["batch_stats"]["mean"])))          # staged, not written
    (torch.sin(y.permute(0, 2, 3, 1)) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx,
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(port.weight.grad.numpy(), gp["scale"],
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(port.bias.grad.numpy(), gp["bias"], atol=1e-5,
                               rtol=1e-4)
    tl.commit_state(port)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               new["batch_stats"]["mean"], atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(),
                               new["batch_stats"]["var"], atol=1e-6, rtol=1e-5)
    assert port._pending is None
    port(tx, train=True)
    tl.drop_state(port)                                 # forgotten
    np.testing.assert_allclose(port.running_var.numpy(),
                               new["batch_stats"]["var"], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("k,pad,bias", [(3, 1, True), (4, 2, False)])
def test_spectralnorm_power_iteration(k, pad, bias):
    """update=True: one power iteration from the stored u in f32, u and v
    staged (commit_state writes them), sigma from the new u and v, and the
    gradient through u and v as jax.grad gives it (the JAX package does not
    stop it, unlike torch.nn.utils.spectral_norm)."""
    jx, tx = _x((2, 8, 7, 6))
    m = jl.SpectralNorm2d(4, k, padding=pad, use_bias=bias)
    v = m.init(jax.random.PRNGKey(0), jx)
    v = {"params": _rand_like_tree(v["params"]),
         "aux": _rand_like_tree(v["aux"], 1.0)}
    r = _rng.standard_normal(np.shape(m.apply(v, jx))).astype(np.float32)

    def f(params, x):
        y, new = m.apply({"params": params, "aux": v["aux"]}, x,
                         update_stats=True, pre_act="leaky0.2", mutable=["aux"])
        return jnp.sum(y * r), (y, new)

    (_, (want, new)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                                    has_aux=True)(v["params"], jx)
    port = tl.SpectralNorm2d(6, 4, k, padding=pad, bias=bias, device="cpu")
    load_jax_variables(port, v)
    u0 = port.u.clone()
    xt = tx.clone().requires_grad_(True)
    y = port(xt, pre_act="leaky0.2", update=True)
    _close(y, want, atol=1e-4)
    assert torch.equal(port.u, u0)                      # staged only
    (y.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    wgrad = port.weight.grad.permute(2, 3, 1, 0).numpy()
    np.testing.assert_allclose(wgrad, gp["kernel"], atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx,
                               atol=1e-5, rtol=1e-4)
    tl.commit_state(port)
    np.testing.assert_allclose(port.u.numpy(), new["aux"]["u"], atol=1e-6)
    np.testing.assert_allclose(port.v.numpy(), new["aux"]["v"], atol=1e-6)
    # the gradient through u and v is real: stopping it changes the kernel's
    port2 = tl.SpectralNorm2d(6, 4, k, padding=pad, bias=bias, device="cpu")
    load_jax_variables(port2, v)
    with torch.no_grad():
        w = port2.weight.reshape(4, -1)
        vv = port2._l2(port2.u @ w)
        uu = port2._l2(w @ vv)
    sigma = torch.dot(uu, port2.weight.reshape(4, -1) @ vv)
    y2 = tl.conv_forward(tx, port2.weight / sigma, port2.bias, 1, pad, "leaky0.2")
    (y2.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    assert not torch.allclose(port2.weight.grad, port.weight.grad, atol=1e-6)


def test_param_dtype_policy_rounds_parameters():
    """Under precision.param_dtype(bf16) an f32 module reads its weights
    rounded to bf16 where it uses them, whatever dtype it computes in, and
    gradients reach the f32 parameters."""
    from hrviton_tpu_torch.core import precision
    conv = tl.Conv2d(4, 3, 3, padding=1, device="cpu")
    tl.init_weights(conv, torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, 6, 6)
    with precision.param_dtype(torch.bfloat16):
        y = conv(x)
    want = F.conv2d(x, conv.weight.bfloat16().float(), conv.bias.bfloat16().float(),
                    1, 1)
    torch.testing.assert_close(y, want, atol=1e-6, rtol=1e-6)
    y.sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    assert not torch.equal(conv(x), y)                   # policy gone after
