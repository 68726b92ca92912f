"""Helpers shared by the port's parity tests (no tests of its own).

``random_variables`` builds a JAX model's variable tree from its shapes
(``jax.eval_shape`` of ``init``, no compile) with random numpy values at
scales that keep activations O(1): kernels N(0, 1/fan_in), biases and
BatchNorm shifts N(0, 0.1), BatchNorm scales 1 + N(0, 0.1), running
variances in [0.5, ...), SPADE noise_scale N(0, 0.5) (non-zero, so noise
wiring errors show), spectral u random and v = normalize(W^T u).

``open_port_gates`` forces the port's kernel dispatch open on the CPU, with
the shape rules the JAX gates have in interpret mode, so that the port's
knob branches run (through the wrappers' plain versions).

``assert_within_ulps`` holds a bf16 result against a reference in bf16 ulps
of max|ref| (one ulp: 2^-7 * max|ref|), at the worst element and on average.

``injected_noise`` replaces ``jax.random.normal`` for the per-norm (B, H, W, 1)
noise fields with numpy draws and records them in call order; the port then
consumes the same list.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np


def _fill(tree, rng, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng, path + (k,))
            continue
        r = rng.standard_normal(v.shape).astype(np.float32)
        if path[0] == "aux":
            out[k] = r                                   # fixed below
        elif k == "kernel":
            out[k] = r / np.float32(np.sqrt(np.prod(v.shape[:-1])))
        elif k in ("bias", "mean"):
            out[k] = r * 0.1
        elif k == "var":
            out[k] = np.abs(r) * 0.5 + 0.5
        elif k == "scale":
            out[k] = 1.0 + r * 0.1
        elif k == "noise_scale":
            out[k] = r * 0.5
        else:
            raise KeyError("/".join(path + (k,)))
    return out


def _spectral_uv(params, aux):
    for k, sub in aux.items():
        if "u" in sub:
            w = params[k]["kernel"]
            wm = w.transpose(3, 2, 0, 1).reshape(w.shape[-1], -1)
            u = (sub["u"] / np.linalg.norm(sub["u"])).astype(np.float32)
            v = u @ wm
            sub["u"], sub["v"] = u, (v / np.linalg.norm(v)).astype(np.float32)
        else:
            _spectral_uv(params[k], sub)


def random_variables(module, rngs, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(rngs, *args, **kwargs))
    tree = _fill(_plain(shapes), np.random.default_rng(seed))
    if "aux" in tree:
        _spectral_uv(tree["params"], tree["aux"])
    return tree


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else v for k, v in tree.items()}


@contextlib.contextmanager
def injected_noise(rng):
    """Yield the list of noise fields drawn while the context is open."""
    real = jax.random.normal
    draws = []

    def normal(key, shape=(), dtype=jnp.float32):
        if len(shape) == 4 and shape[-1] == 1:           # a (B, H, W, 1) field
            a = rng.standard_normal(shape).astype(np.float32)
            draws.append(a)
            return jnp.asarray(a, dtype)
        return real(key, shape, dtype)

    jax.random.normal = normal
    try:
        yield draws
    finally:
        jax.random.normal = real


def open_port_gates(monkeypatch, knobs, th=4):
    """Patch the port's gates for the named knobs ('fast_spade', 'fast_conv',
    'views') to the JAX gates' interpret-mode rules at ``th`` rows per step,
    whatever the device. Returns the list that records each kernel asked
    for ('modulate' | 'wide' | 'small')."""
    from hrviton_tpu_torch.models import spade as tspade
    from hrviton_tpu_torch.ops import conv3x3 as tc3
    from hrviton_tpu_torch.ops import spade_fused as tsf
    asked = []

    def rows_ok(h, w, wmod):
        return h % th == 0 and w % wmod == 0 and h > th

    if "fast_spade" in knobs:
        def mod_gate(x_shape, nh, dtype, device):
            ok = (tsf.fast_spade_enabled() and nh % 128 == 0
                  and rows_ok(x_shape[1], x_shape[2], 8))
            if ok:
                asked.append("modulate")
            return ok
        monkeypatch.setattr(tspade, "fused_spade_eligible", mod_gate)

    def kernel_for(x_shape, w_shape, stride, padding, dtype, device):
        _, h, w, cin = x_shape
        if ("views" in knobs and rows_ok(h, w, 128) and w_shape[0] * 3 <= 128
                and cin * 3 <= 128):
            asked.append("small")
            return tc3.conv3x3_small
        if ("fast_conv" in knobs and tc3.fast_conv_enabled()
                and rows_ok(h, w, 8)):
            asked.append("wide")
            return tc3.conv3x3_wide
        return None

    if "fast_conv" in knobs or "views" in knobs:
        monkeypatch.setattr(tc3, "kernel_for", kernel_for)
    return asked


def assert_within_ulps(got, want, max_ulps, mean_ulps):
    """|got - want| within ``max_ulps`` bf16 ulps of max|want| at the worst
    element and ``mean_ulps`` on average; got a torch tensor, want a JAX or
    numpy array."""
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    ulp = 2.0 ** -7 * float(np.abs(b).max())
    d = np.abs(a - b)
    assert np.isfinite(a).all()
    assert d.max() <= max_ulps * ulp and d.mean() <= mean_ulps * ulp, (
        d.max() / ulp, d.mean() / ulp)


def _tree_max(tree):
    return max(_tree_max(v) if isinstance(v, dict)
               else float(np.abs(np.asarray(jnp.asarray(v).astype(jnp.float32))).max())
               for v in tree.values())


def close_per_tensor(got, want, rel, noise=None, path="", zero=None):
    """Every leaf of the nested dict ``got`` (numpy) within ``rel`` x
    max|want| of the same leaf of ``want``, or within four times the leaf
    of ``noise`` where that is larger: ``noise`` holds how far the
    reference itself moves between two evaluations that are equal in exact
    arithmetic (one reordering of its sums among the many another
    implementation makes, so a lower bound of its rounding noise), below
    which no implementation can be held. A
    leaf whose reference is below 1e-5 of the tree's largest value is zero
    in exact arithmetic (a conv bias ahead of an affine-free instance norm):
    both sides must stay below that. Both trees hold the same keys."""
    if zero is None:
        zero = 1e-5 * _tree_max(want)
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        sub = None if noise is None else noise[k]
        if isinstance(want[k], dict):
            close_per_tensor(got[k], want[k], rel, sub, f"{path}/{k}", zero)
            continue
        a = np.asarray(got[k], np.float32)
        b = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
        assert a.shape == b.shape, (path, k, a.shape, b.shape)
        if float(np.abs(b).max()) < zero:
            assert float(np.abs(a).max()) < zero, (f"{path}/{k}", zero)
            continue
        lim = rel * max(float(np.abs(b).max()), 1e-30)
        if sub is not None:
            lim = max(lim, 4.0 * float(np.abs(np.asarray(sub)).max()))
        d = float(np.abs(a - b).max())
        assert d <= lim, (f"{path}/{k}", d, lim)


def tree_diff(a, b):
    """|a - b| leaf by leaf (nested dicts of arrays)."""
    return {k: tree_diff(a[k], b[k]) if isinstance(a[k], dict)
            else np.abs(np.asarray(a[k], np.float32) - np.asarray(b[k], np.float32))
            for k in a}


def reverse_batch(tree):
    """Every array of a (nested) batch dict with its samples in reverse
    order."""
    return {k: reverse_batch(v) if isinstance(v, dict) else np.asarray(v)[::-1].copy()
            for k, v in tree.items()}


def grad_tree(module):
    """The ``.grad`` of every parameter of a port module (zeros where it
    has none) as the JAX params tree (``convert.export_jax_variables``'s
    layout)."""
    import torch
    from hrviton_tpu_torch.convert import export_jax_variables
    params = list(module.parameters())
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
    try:
        return export_jax_variables(module)["params"]
    finally:
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)
