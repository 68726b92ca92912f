"""Whole models: the port vs the JAX package at a small width, CPU.

Random variables (tests/test_torch_support.py: random biases, BatchNorm running
stats and spectral u/v, non-zero SPADE noise_scale) go to the JAX model and,
through ``load_jax_variables``, to the port. The SPADE noise is injected: the
port consumes the JAX apply's own draws in the same order. Tolerance 2e-4
absolute / 1e-3 relative: two dozen conv + norm layers, each summing f32
products in another order on the two sides.

The same models also run in bf16 on both sides (the JAX package's bf16
policy: variables cast with ``bf16_params``, bf16 inputs; the port built in
bf16). Tolerances there are in bf16 ulps of max|ref|, one ulp taken as
2^-7 * max|ref| (as chip_smoke.py states its own): the two frameworks round
the same intermediates to bf16 but sum in other orders, and a flipped
rounding in one layer travels through the next ones. The limits are about
twice the differences seen at these sizes.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.core.precision import bf16_params
from hrviton_tpu.config import TOCGConfig as JTOCGConfig
from hrviton_tpu.models import ConditionGenerator as JCondition
from hrviton_tpu.models import SPADEGenerator as JSPADE
from hrviton_tpu.ops.grid_sample import make_grid as jmake_grid
from hrviton_tpu_torch.config import SPADEGenConfig, TOCGConfig
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.models import ConditionGenerator, SPADEGenerator
from hrviton_tpu_torch.models import condition as tcond
from hrviton_tpu_torch.models import spade as tspade
from test_torch_support import assert_within_ulps, injected_noise, random_variables

torch.set_num_threads(1)
_ATOL, _RTOL = 2e-4, 1e-3


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    # another test file may import the JAX kernel in interpret mode; keep its
    # gate closed so the JAX generator takes its plain path on the CPU
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


def _close(t, j, atol=_ATOL, rtol=_RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("warp_feature,out_layer", [("T1", "relu"),
                                                    ("encoder", "conv")])
def test_condition_generator(warp_feature, out_layer):
    h, w = 64, 64
    rng = np.random.default_rng(0)
    m = JCondition(JTOCGConfig(ngf=8, warp_feature=warp_feature,
                               out_layer=out_layer))
    v = random_variables(m, jax.random.PRNGKey(0), jnp.zeros((1, h, w, 4)),
                         jnp.zeros((1, h, w, 16)), train=False)
    i1 = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    i2 = rng.standard_normal((2, h, w, 16)).astype(np.float32)
    flows, seg, wc, wcm = jax.jit(
        lambda v_, a, b: m.apply(v_, a, b, train=False))(v, i1, i2)
    port = ConditionGenerator(TOCGConfig(ngf=8, warp_feature=warp_feature,
                                         out_layer=out_layer), device="cpu")
    load_jax_variables(port, v)
    with torch.no_grad():
        pflows, pseg, pwc, pwcm = port(torch.from_numpy(i1),
                                       torch.from_numpy(i2))
    assert np.abs(np.asarray(flows[-1])).max() > 0.1     # a real warp
    for a, b in zip(pflows, flows):
        _close(a, b)
    _close(pseg, seg)
    _close(pwc, wc)
    _close(pwcm, wcm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flow_grid_matches_jax(dtype, monkeypatch):
    """The tocg's warp grid: the flow divided by the level's half-extent in
    the flow's own dtype, plus the f32 identity grid, bit for bit as the JAX
    tocg forms it (``hrviton_tpu/models/condition.py``, the two ``fn``).
    Both sides add the same identity grid (the two linspaces may differ in
    the last bit)."""
    n, ih, iw = 2, 16, 24
    monkeypatch.setattr(tcond, "make_grid", lambda n_, h_, w_, device: (
        torch.from_numpy(np.asarray(jmake_grid(n_, h_, w_)))))
    flow = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (n, 2, ih, iw)).astype(np.float32) * 3).to(dtype)
    norm_w, norm_h = (iw / 2 - 1.0) / 2.0, (ih / 2 - 1.0) / 2.0
    jflow = jnp.asarray(flow.float().permute(0, 2, 3, 1).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jnp.stack([jflow[..., 0] / norm_w, jflow[..., 1] / norm_h],
                     axis=-1) + jmake_grid(n, ih, iw)
    got = tcond._flow_grid(flow, ih, iw, norm_w, norm_h)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (output, max ulps, mean ulps) of the bf16 tocg: the warped cloth samples a
# random-noise image, where a grid one ulp off moves a sample across a
# contrast of up to twice max|ref|
_TOCG_BF16_ULPS = [("flow", 12, 1.5), ("seg", 24, 1.0), ("warped_c", 96, 4.0),
                   ("warped_cm", 96, 4.0)]


@pytest.mark.parametrize("warp_feature,out_layer", [("T1", "relu"),
                                                    ("encoder", "conv")])
def test_condition_generator_bf16(warp_feature, out_layer):
    h, w = 64, 64
    rng = np.random.default_rng(0)
    m = JCondition(JTOCGConfig(ngf=8, warp_feature=warp_feature,
                               out_layer=out_layer))
    v = random_variables(m, jax.random.PRNGKey(0), jnp.zeros((1, h, w, 4)),
                         jnp.zeros((1, h, w, 16)), train=False)
    i1 = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    i2 = rng.standard_normal((2, h, w, 16)).astype(np.float32)
    bf = jnp.bfloat16
    flows, seg, wc, wcm = jax.jit(
        lambda v_, a, b: m.apply(v_, a, b, train=False))(
            bf16_params(v), jnp.asarray(i1, bf), jnp.asarray(i2, bf))
    port = ConditionGenerator(TOCGConfig(ngf=8, warp_feature=warp_feature,
                                         out_layer=out_layer), device="cpu",
                              dtype=torch.bfloat16)
    load_jax_variables(port, v)
    with torch.no_grad():
        pflows, pseg, pwc, pwcm = port(torch.from_numpy(i1).bfloat16(),
                                       torch.from_numpy(i2).bfloat16())
    assert pseg.dtype == torch.bfloat16 and seg.dtype == bf
    lim = {name: (mx, mean) for name, mx, mean in _TOCG_BF16_ULPS}
    for a, b in zip(pflows, flows):
        assert_within_ulps(a, b, *lim["flow"])
    assert_within_ulps(pseg, seg, *lim["seg"])
    assert_within_ulps(pwc, wc, *lim["warped_c"])
    assert_within_ulps(pwcm, wcm, *lim["warped_cm"])


@functools.lru_cache(maxsize=None)
def _jax_generator(mode, h, w):
    """(variables, x, labels, noise draws, rgb) of one JAX generator run."""
    rng = np.random.default_rng(1)
    m = JSPADE(JSPADEGenConfig(ngf=8, num_upsampling_layers=mode,
                               fine_height=h, fine_width=w, remat=False))
    k = jax.random.PRNGKey(0)
    v = random_variables(m, {"params": k, "noise": k},
                         jnp.zeros((1, h, w, 9)), jnp.zeros((1, h, w, 7)),
                         train=False)
    x = rng.standard_normal((2, h, w, 9)).astype(np.float32)
    labels = rng.integers(0, 7, (2, h, w)).astype(np.int32)
    with injected_noise(rng) as draws:
        out = jax.jit(lambda v_, x_, l_: m.apply(
            v_, x_, l_, train=False, rngs={"noise": k}))(v, x, labels)
    return v, x, labels, draws, np.asarray(out)


@pytest.mark.parametrize("mode,h,w", [("most", 256, 128), ("more", 128, 64)])
def test_spade_generator_injected_noise(mode, h, w):
    v, x, labels, draws, want = _jax_generator(mode, h, w)
    n_blocks = 8 if mode == "most" else 7
    assert len(draws) == 2 + 3 * (n_blocks - 1)   # head_0 has no shortcut
    assert 0.05 < want.std() < 0.9                 # tanh not saturated
    port = SPADEGenerator(SPADEGenConfig(ngf=8, num_upsampling_layers=mode,
                                         fine_height=h, fine_width=w),
                          device="cpu")
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(labels), draws)
        onehot = torch.nn.functional.one_hot(torch.from_numpy(labels).long(),
                                             7).float()
        got_onehot = port(torch.from_numpy(x), onehot, draws)
    _close(got, want)
    torch.testing.assert_close(got_onehot, got, atol=0, rtol=0)


@pytest.mark.parametrize("mode,h,w", [("most", 256, 128), ("more", 128, 64)])
def test_spade_generator_bf16(mode, h, w):
    """bf16 on both sides, the same variables and injected noise: the rgb
    within 12 ulps of max|ref| at most and 1 ulp on average (seen: 6 and
    0.56)."""
    v, x, labels, _, _ = _jax_generator(mode, h, w)
    m = JSPADE(JSPADEGenConfig(ngf=8, num_upsampling_layers=mode,
                               fine_height=h, fine_width=w, remat=False))
    k = jax.random.PRNGKey(0)
    with injected_noise(np.random.default_rng(2)) as draws:
        want = jax.jit(lambda v_, x_, l_: m.apply(
            v_, x_, l_, train=False, rngs={"noise": k}))(
                bf16_params(v), jnp.asarray(x, jnp.bfloat16), labels)
    assert want.dtype == jnp.bfloat16
    port = SPADEGenerator(SPADEGenConfig(ngf=8, num_upsampling_layers=mode,
                                         fine_height=h, fine_width=w),
                          device="cpu", dtype=torch.bfloat16)
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(labels),
                   draws)
    assert got.dtype == torch.bfloat16
    assert_within_ulps(got, want, 12, 1.0)


def test_spade_fused_dispatch_on_cpu(monkeypatch):
    """Force the fused-unit dispatch open on the CPU: each {SPADENorm, conv}
    pair of up_3 and up_4 then runs spade_conv_unit's plain version. It must
    give the JAX generator's output from the same weights and noise."""
    h, w = 256, 128
    v, x, labels, draws, want = _jax_generator("most", h, w)
    calls = []

    def gate(hh, ww, nh, dtype, device):
        calls.append(hh)
        return hh >= 128                   # up_3 and up_4 at this size

    monkeypatch.setattr(tspade, "fused_spade_conv_eligible", gate)
    port = SPADEGenerator(SPADEGenConfig(ngf=8, fine_height=h, fine_width=w),
                          device="cpu")
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(labels), draws)
    assert sorted(c for c in calls if c >= 128) == [128, 256]
    _close(got, want)


def test_load_jax_variables_fills_every_tensor():
    v = _jax_generator("most", 256, 128)[0]
    port = SPADEGenerator(SPADEGenConfig(ngf=8, fine_height=256,
                                         fine_width=128), device="cpu")
    filled = load_jax_variables(port, v)
    state = dict(port.named_parameters()) | dict(port.named_buffers())
    assert sorted(filled) == sorted(state)
    np.testing.assert_array_equal(
        port.up_4.conv_0.weight.detach().numpy(),
        v["params"]["up_4"]["conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port.up_4.conv_0.u.numpy(),
                                  v["aux"]["up_4"]["conv_0"]["u"])
    bad = {"params": {"head_0": {"norm_0": {"nope": np.zeros(3)}}}}
    with pytest.raises(KeyError):
        load_jax_variables(port, bad, strict=False)
    partial = {"params": {"conv_img": v["params"]["conv_img"]}}
    with pytest.raises(KeyError, match="not filled"):
        load_jax_variables(port, partial)


@pytest.mark.parametrize("knob", ["s2d_tail", "fast_conv", "fast_spade",
                                  "merge_gamma_beta"])
def test_load_jax_variables_fills_generator_with_knob(knob):
    """No knob changes the parameter tree: the variables of the plain JAX
    generator fill a port generator built with any knob, tensor for tensor
    as they fill the plain one."""
    v = _jax_generator("most", 256, 128)[0]
    kw = dict(ngf=8, fine_height=256, fine_width=128)
    plain = SPADEGenerator(SPADEGenConfig(**kw), device="cpu")
    port = SPADEGenerator(SPADEGenConfig(**kw, **{knob: True}), device="cpu")
    assert sorted(load_jax_variables(port, v)) == sorted(load_jax_variables(plain, v))
    want = dict(plain.named_parameters()) | dict(plain.named_buffers())
    got = dict(port.named_parameters()) | dict(port.named_buffers())
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        torch.testing.assert_close(t, want[name], atol=0, rtol=0)
