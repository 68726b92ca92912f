"""Helpers shared by the port's parity tests (no tests of its own).

``random_variables`` builds a JAX model's variable tree from its shapes
(``jax.eval_shape`` of ``init``, no compile) with random numpy values at
scales that keep activations O(1): kernels N(0, 1/fan_in), biases and
BatchNorm shifts N(0, 0.1), BatchNorm scales 1 + N(0, 0.1), running
variances in [0.5, ...), SPADE noise_scale N(0, 0.5) (non-zero, so noise
wiring errors show), spectral u random and v = normalize(W^T u).

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
