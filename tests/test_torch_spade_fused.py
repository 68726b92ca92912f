"""The fused SPADE modulation: the port's fused_spade_modulate (plain version
on the CPU) vs the JAX package's Pallas kernel in interpret mode, and the
port's SPADENorm / SPADEResBlock with the fast-spade, fast-conv and
merge-gamma-beta branches forced open on the CPU vs the JAX modules with the
same knobs on (Pallas in interpret mode), f32, same weights and noise. The
CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerance 1e-4 absolute and relative: gamma and beta sum 9*128 f32 products
each, in different orders on the two sides; a block chains three such norms
and three convs, at 2e-4 / 1e-3 (as tests/test_torch_models.py).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.models import spade as jspade
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.models import spade as tspade
from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.ops import spade_fused as tsf
from test_torch_support import (injected_noise, open_port_gates,
                                random_variables)

c3 = importlib.import_module("hrviton_tpu.ops.conv3x3")
sf = importlib.import_module("hrviton_tpu.ops.spade_fused")
sb = importlib.import_module("hrviton_tpu.ops.spade_block")
torch.set_num_threads(1)
_rng = np.random.default_rng(0)
_ORDER = ("x", "noise", "nscale", "actv", "wg", "bg", "wb", "bb")


@pytest.fixture(autouse=True)
def _interpret_small_tiles(monkeypatch):
    for mod in (sf, c3):
        monkeypatch.setattr(mod, "_INTERPRET", True)
        monkeypatch.setattr(mod, "_TH", 4)
    monkeypatch.setattr(sb, "_INTERPRET", False)


def _arr(shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(b=2, h=16, w=16, c=8, nh=128):
    return dict(x=_arr((b, h, w, c)), noise=_arr((b, h, w, 1)),
                nscale=_arr((c,), 0.1), actv=_arr((b, h, w, nh)),
                wg=_arr((3, 3, nh, c), 0.05), bg=_arr((c,), 0.1),
                wb=_arr((3, 3, nh, c), 0.05), bb=_arr((c,), 0.1))


def _compare(arrs):
    with sf.fast_spade(True):
        assert sf.fused_spade_eligible(arrs["x"].shape, arrs["actv"].shape[-1],
                                       jnp.float32)
        want = sf.fused_spade_modulate(*(jnp.asarray(arrs[k]) for k in _ORDER))
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("wg", "wb"):                             # HWIO -> OIHW
        t[k] = t[k].permute(3, 2, 0, 1)
    before = tsf.fused_spade_modulate.launches
    got = tsf.fused_spade_modulate(*(t[k] for k in _ORDER))
    assert tsf.fused_spade_modulate.launches == before   # no kernel on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("c,h,w", [(8, 16, 16), (40, 16, 16), (272, 8, 8)])
def test_modulate_matches_pallas(c, h, w):
    """C = 272 is up_2's norm_s / norm_0 (six N tiles of 48 on the card)."""
    _compare(_inputs(h=h, w=w, c=c))


def test_modulate_edge_rows():
    """Constant activations expose wrong halo handling at the borders."""
    arrs = _inputs(b=1, h=24, w=8, c=4)
    arrs["actv"] = np.ones_like(arrs["actv"])
    _compare(arrs)


def test_modulate_zero_noise_scale_ignores_noise():
    arrs = _inputs(b=1, h=8, w=8, c=4)
    arrs["nscale"][:] = 0.0
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("wg", "wb"):
        t[k] = t[k].permute(3, 2, 0, 1)
    a = tsf.fused_spade_modulate(*(t[k] for k in _ORDER))
    t["noise"] = t["noise"] * 5.0
    torch.testing.assert_close(tsf.fused_spade_modulate(*(t[k] for k in _ORDER)),
                               a, atol=0, rtol=0)


def test_gate_and_switch():
    gate = tsf.fused_spade_eligible
    shape = (4, 256, 192, 272)
    assert not tsf.fast_spade_enabled()
    assert not gate(shape, 128, torch.bfloat16, "cuda")      # switch off
    with tsf.fast_spade(True):
        assert tsf.fast_spade_enabled()
        assert gate(shape, 128, torch.bfloat16, "cuda")
        assert gate(shape, 128, torch.float32, "cuda")
        assert not gate(shape, 128, torch.bfloat16, "cpu")
        assert not gate(shape, 128, torch.float16, "cuda")
        assert not gate(shape, 96, torch.bfloat16, "cuda")           # nhidden
        assert not gate((4, 128, 96, 528), 128, torch.bfloat16, "cuda")  # h < 256
        assert not gate((4, 264, 192, 8), 128, torch.bfloat16, "cuda")   # h % 16
        assert not gate((4, 256, 100, 8), 128, torch.bfloat16, "cuda")   # w % 8
        with pytest.raises(RuntimeError):      # restored on an exception too
            with tsf.fast_spade(False):
                raise RuntimeError
        assert tsf.fast_spade_enabled()
    assert not tsf.fast_spade_enabled()
    tsf.enable_fast_spade(True)
    assert tsf.fast_spade_enabled()
    tsf.enable_fast_spade(False)


def _jax_switches(knobs):
    stack = contextlib.ExitStack()
    if "fast_spade" in knobs:
        stack.enter_context(sf.fast_spade(True))
    if "fast_conv" in knobs:
        stack.enter_context(c3.fast_conv(True))
    if "merge_gamma_beta" in knobs:
        stack.enter_context(jspade.merge_gamma_beta(True))
    return stack


def _port_switches(knobs):
    stack = contextlib.ExitStack()
    if "fast_spade" in knobs:
        stack.enter_context(tsf.fast_spade(True))
    if "fast_conv" in knobs:
        stack.enter_context(tc3.fast_conv(True))
    if "merge_gamma_beta" in knobs:
        stack.enter_context(tspade.merge_gamma_beta(True))
    return stack


def _run_module(jmod, tmod, x_c, knobs, monkeypatch, atol, rtol):
    """Same variables, inputs and noise through the JAX module with the
    knobs on and the port module with the knobs on and off."""
    rng = np.random.default_rng(5)
    h, w = 16, 16
    x, seg = _arr((2, h, w, x_c)), _arr((2, h, w, 7))
    k = jax.random.PRNGKey(0)
    v = random_variables(jmod, {"params": k, "noise": k}, jnp.zeros((1, h, w, x_c)),
                         jnp.zeros((1, h, w, 7)), train=False)
    with _jax_switches(knobs), injected_noise(rng) as draws:
        want = jmod.apply(v, jnp.asarray(x), jnp.asarray(seg), train=False,
                          rngs={"noise": k})
    load_jax_variables(tmod, v)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tseg = torch.from_numpy(seg).permute(0, 3, 1, 2)
    with torch.no_grad():
        off = tmod(tx, tseg, tspade.noise_source(draws, "cpu"))
        asked = open_port_gates(monkeypatch, knobs)
        with _port_switches(knobs):
            on = tmod(tx, tseg, tspade.noise_source(draws, "cpu"))
    np.testing.assert_allclose(on.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)
    torch.testing.assert_close(on, off, atol=atol, rtol=rtol)
    return asked


@pytest.mark.parametrize("knobs,asked", [
    (("fast_spade",), ["modulate"]),
    (("fast_conv",), ["wide", "wide", "wide"]),
    (("merge_gamma_beta",), []),
    (("merge_gamma_beta", "fast_conv"), ["wide", "wide"]),
])
def test_spade_norm_knobs(knobs, asked, monkeypatch):
    got = _run_module(jspade.SPADENorm(8, 7), tspade.SPADENorm(8, 7, device="cpu"),
                      8, knobs, monkeypatch, 1e-4, 1e-4)
    assert got == asked


@pytest.mark.parametrize("knobs,n_asked", [
    (("fast_spade",), 3), (("fast_conv",), 11), (("fast_spade", "fast_conv"), 8)])
def test_spade_resblock_knobs(knobs, n_asked, monkeypatch):
    """A block with a learned shortcut: three norms; with fast_conv alone
    each norm's three 3x3 convs and conv_0, conv_1 go to the wide wrapper;
    with both, the norms go to the modulation and their conv_shared and the
    block's two 3x3 convs to the wide wrapper."""
    got = _run_module(
        jspade.SPADEResBlock(8, 6, norm_g="spectralaliasinstance", gen_semantic_nc=7),
        tspade.SPADEResBlock(8, 6, device="cpu"), 8, knobs, monkeypatch, 2e-4, 1e-3)
    assert len(got) == n_asked


def test_switch_restored_after_generator_call():
    """A generator enters its knobs for the length of its call only, so they
    cannot leak into the tocg or a second generator."""
    from hrviton_tpu_torch.config import SPADEGenConfig
    from hrviton_tpu_torch.models import SPADEGenerator
    seen = []

    class Probe(SPADEGenerator):
        def _forward(self, x, seg, noise):
            seen.append((tc3.fast_conv_enabled(), tsf.fast_spade_enabled(),
                         tspade._MERGE_GB))
            raise RuntimeError("stop")

    gen = Probe(SPADEGenConfig(ngf=8, fine_height=256, fine_width=128,
                               fast_conv=True, fast_spade=True,
                               merge_gamma_beta=True), device="cpu")
    with pytest.raises(RuntimeError, match="stop"):
        gen(torch.zeros(1, 256, 128, 9), torch.zeros(1, 256, 128, 7),
            torch.Generator())
    assert seen == [(True, True, True)]
    assert (tc3.fast_conv_enabled(), tsf.fast_spade_enabled(),
            tspade._MERGE_GB) == (False, False, False)
