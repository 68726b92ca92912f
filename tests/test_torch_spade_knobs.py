"""The SPADE generator under each dispatch knob: the port vs the JAX package
with the same knob on, at a small width (ngf=8, 'most', 256x128), f32, CPU,
same weights (``load_jax_variables``), same injected noise, non-zero
noise_scale; and knob on vs knob off inside the port.

The JAX side of the kernel configuration (fast_spade + fast_conv + the
small-channel switch) runs its three Pallas kernels in interpret mode. Under
fast_spade or fast_conv alone it takes its plain reference, which is what its
gates choose on the CPU. The port's gates never open on the CPU, so they are
forced open with the interpret-mode rules (test_torch_support.open_port_gates)
and the branches run through the wrappers' plain versions; no kernel launches.

Tolerance 2e-4 absolute / 1e-3 relative, as tests/test_torch_models.py: two
dozen conv + norm layers, each summing f32 products in another order.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.models import SPADEGenerator as JSPADE
from hrviton_tpu_torch.config import SPADEGenConfig
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.models import SPADEGenerator
from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.ops import spade_block as tsb
from hrviton_tpu_torch.ops import spade_fused as tsf
from test_torch_support import (injected_noise, open_port_gates,
                                random_variables)

c3 = importlib.import_module("hrviton_tpu.ops.conv3x3")
sf = importlib.import_module("hrviton_tpu.ops.spade_fused")
sb = importlib.import_module("hrviton_tpu.ops.spade_block")
torch.set_num_threads(1)
H, W = 256, 128
_ATOL, _RTOL = 2e-4, 1e-3
KERNEL_KNOBS = ("fast_spade", "fast_conv", "views")


def _cfg(cls, knobs, **kw):
    return cls(ngf=8, num_upsampling_layers="most", fine_height=H, fine_width=W,
               fused_block=False, **{k: True for k in knobs if k != "views"}, **kw)


def _set_jax_kernels(monkeypatch, knobs):
    interpret = set(KERNEL_KNOBS) <= set(knobs)
    for mod in (c3, sf):
        monkeypatch.setattr(mod, "_INTERPRET", interpret)
        monkeypatch.setattr(mod, "_TH", 4)
    monkeypatch.setattr(c3, "_VTH", 4)
    monkeypatch.setattr(c3, "_VIEWS", "views" in knobs)
    monkeypatch.setattr(sb, "_INTERPRET", False)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(1)
    m = JSPADE(_cfg(JSPADEGenConfig, (), remat=False))
    k = jax.random.PRNGKey(0)
    v = random_variables(m, {"params": k, "noise": k}, jnp.zeros((1, H, W, 9)),
                         jnp.zeros((1, H, W, 7)), train=False)
    x = rng.standard_normal((2, H, W, 9)).astype(np.float32)
    labels = rng.integers(0, 7, (2, H, W)).astype(np.int32)
    return v, x, labels


def _jax_run(knobs):
    """(noise draws, rgb) of the JAX generator with the knobs on."""
    v, x, labels = _inputs()
    m = JSPADE(_cfg(JSPADEGenConfig, knobs, remat=False))
    k = jax.random.PRNGKey(0)
    with injected_noise(np.random.default_rng(2)) as draws:
        out = jax.jit(lambda v_, x_, l_: m.apply(
            v_, x_, l_, train=False, rngs={"noise": k}))(v, x, labels)
    return draws, np.asarray(out)


def _port_run(knobs, draws, monkeypatch=None):
    v, x, labels = _inputs()
    port = SPADEGenerator(_cfg(SPADEGenConfig, knobs), device="cpu")
    load_jax_variables(port, v)
    asked = open_port_gates(monkeypatch, knobs) if monkeypatch else []
    counters = (tsb.spade_conv_unit, tsf.fused_spade_modulate, tc3.conv3x3_wide,
                tc3.conv3x3_small)
    before = [c.launches for c in counters]
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(labels), draws)
    assert [c.launches for c in counters] == before     # no kernel on the CPU
    assert not tc3.fast_conv_enabled() and not tsf.fast_spade_enabled()
    return got.numpy(), asked


@pytest.mark.parametrize("knobs", [
    ("s2d_tail",), ("merge_gamma_beta",), ("fast_spade",), ("fast_conv",),
    ("merge_gamma_beta", "fast_conv"), KERNEL_KNOBS], ids="+".join)
def test_generator_knob_matches_jax(knobs, monkeypatch):
    _set_jax_kernels(monkeypatch, knobs)
    draws, want = _jax_run(knobs)
    assert len(draws) == 23 and 0.05 < want.std() < 0.9    # tanh not saturated
    off, _ = _port_run((), draws)
    on, asked = _port_run(knobs, draws, monkeypatch)
    np.testing.assert_allclose(on, want, atol=_ATOL, rtol=_RTOL)
    np.testing.assert_allclose(on, off, atol=_ATOL, rtol=_RTOL)
    # the interpret-mode rules (h % 4 == 0, w % 8 == 0) admit 16x8 and up:
    # the three norms of up_0 .. up_4
    if "fast_spade" in knobs:
        assert asked.count("modulate") == 15
    if knobs == KERNEL_KNOBS:
        # 256x128 is the one scale with w % 128 == 0: conv_7, up_4's conv_0
        # and conv_1, conv_img
        assert asked.count("small") == 4
        assert asked.count("wide") > 20
    if knobs == ("s2d_tail",):
        assert not asked


def test_s2d_tail_draws_full_res_noise():
    """In the s2d tail the noise fields keep their plain full-res shapes, so
    a list recorded from the plain path is consumed as it is."""
    v, x, labels = _inputs()
    port = SPADEGenerator(_cfg(SPADEGenConfig, ("s2d_tail",)), device="cpu")
    load_jax_variables(port, v)
    shapes = []

    def draw(shape):
        shapes.append(tuple(shape))
        return torch.zeros(shape)

    with torch.no_grad():
        port(torch.from_numpy(x), torch.from_numpy(labels), draw)
    assert shapes[-6:] == [(2, 128, 64, 1)] * 3 + [(2, 256, 128, 1)] * 3
