"""LPIPS, the fake nets, the dataset scores and the evaluation metrics: the
port against the JAX package on the CPU, f32.

``LPIPSModel`` ('alex', 'vgg16', 'squeeze'; lpips and net mode; averaged
and spatial) and ``LPIPSAlex`` on random variables shared through
``load_jax_variables``, at 64x64 on numpy inputs in [-1, 1]. Tolerance f32
1e-5 relative to max|ref| (with 1e-7 absolute: distances are small sums of
normalized features). ``dssim_distance`` takes a 7x7 mean of uint8 levels
(f32, another summation order): 1e-5 relative; ``l2_distance`` 1e-6. The
host numpy functions (``score_2afc``, ``score_jnd``, ``ssim_gray``,
``mse``, ``inception_score``) are copies of the JAX package's: equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.infer import metrics as jmetrics
from hrviton_tpu.losses import lpips as jlpips
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.infer import metrics as tmetrics
from hrviton_tpu_torch.losses import lpips as tlpips
from test_torch_support import random_variables

torch.set_num_threads(1)


def _close(got, want, rel=1e-5, atol=1e-7):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * float(np.abs(want).max()) + atol
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _images(seed, n=2, hw=64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32)
            for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _jax_model(net, lpips, spatial):
    m = jlpips.LPIPSModel(net=net, lpips=lpips, spatial=spatial)
    z = jnp.zeros((1, 64, 64, 3))
    return m, random_variables(m, jax.random.PRNGKey(0), z, z)


@pytest.mark.parametrize("net", ["alex", "vgg16", "squeeze"])
@pytest.mark.parametrize("lpips,spatial", [(True, False), (False, False),
                                           (True, True)])
def test_lpips_model_matches_jax(net, lpips, spatial):
    m, v = _jax_model(net, lpips, spatial)
    x, y = _images(1)
    want = jax.jit(m.apply)(v, x, y)
    port = tlpips.LPIPSModel(net, lpips, spatial, device="cpu")
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, want)
    with pytest.raises(NotImplementedError):
        port(torch.from_numpy(x), torch.from_numpy(y), train=True)


def test_lpips_alex_and_make_lpips_match_jax():
    m = jlpips.LPIPSAlex()
    z = jnp.zeros((1, 64, 64, 3))
    v = random_variables(m, jax.random.PRNGKey(0), z, z)
    x, y = _images(2)
    want = jlpips.make_lpips(v)(x, y)
    fn = tlpips.make_lpips(v, device="cpu")
    got = fn(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, want)
    assert (got > 0).all()
    # LPIPSFn over the same variables, and the same pair: distance 0
    fn2 = tlpips.LPIPSFn(v, device="cpu")
    _close(fn2(torch.from_numpy(x), torch.from_numpy(y)), want)
    assert float(fn2(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) == 0
    # random weights without variables, from a seed
    a = tlpips.make_lpips(seed=3, device="cpu")
    b = tlpips.make_lpips(seed=3, device="cpu")
    assert torch.equal(a(torch.from_numpy(x), torch.from_numpy(y)),
                       b(torch.from_numpy(x), torch.from_numpy(y)))


def test_fake_nets_match_jax():
    x, y = _images(3, n=3, hw=32)
    _close(tlpips.l2_distance(torch.from_numpy(x), torch.from_numpy(y)),
           jlpips.l2_distance(x, y), rel=1e-6)
    _close(tlpips.dssim_distance(torch.from_numpy(x), torch.from_numpy(y)),
           jlpips.dssim_distance(x, y))


def test_dataset_scores_match_jax():
    rng = np.random.default_rng(4)
    d0, d1 = rng.uniform(0, 1, 50), rng.uniform(0, 1, 50)
    d1[:5] = d0[:5]                                    # ties score 0.5
    gts = rng.uniform(0, 1, 50)
    assert tlpips.score_2afc(d0, d1, gts) == jlpips.score_2afc(d0, d1, gts)
    sames = (rng.uniform(0, 1, 50) > 0.5).astype(np.float64)
    assert tlpips.score_jnd(d0, sames) == jlpips.score_jnd(d0, sames)


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (40, 30), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-20, 21, a.shape), 0,
                255).astype(np.uint8)
    assert tmetrics.ssim_gray(a, b) == jmetrics.ssim_gray(a, b)
    rgb = rng.integers(0, 256, (2, 40, 30, 3), dtype=np.uint8)
    assert tmetrics.mse(rgb[0], rgb[1]) == jmetrics.mse(rgb[0], rgb[1])
    logits = rng.standard_normal((12, 1000))
    preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for splits in (1, 3):
        assert tmetrics.inception_score(preds, splits) == \
            jmetrics.inception_score(preds, splits)
