"""The fused SPADE unit: the port's spade_conv_unit (plain version on the
CPU) vs the JAX package's fused_spade_conv Pallas kernel in interpret mode,
f32, same numpy inputs. The CUDA kernel itself is held against its plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerance 1e-4 absolute and relative: gamma/beta sum 9*128 f32 products and
the consumer conv up to 9*40 more, in different orders on the two sides.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu_torch.ops import spade_block as tsb

sb = importlib.import_module("hrviton_tpu.ops.spade_block")
torch.set_num_threads(1)
_rng = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _interpret_small_tiles(monkeypatch):
    monkeypatch.setattr(sb, "_INTERPRET", True)
    monkeypatch.setattr(sb, "_TH", 4)


def _inputs(b=2, h=12, w=128, c=8, cout=16, nh=128, ksize=3, residual=False):
    def a(shape, scale=1.0):
        return (_rng.standard_normal(shape) * scale).astype(np.float32)
    arrs = dict(x=a((b, h, w, c)), noise=a((b, h, w, 1)), nscale=a((c,), 0.1),
                actv=a((b, h, w, nh)), wg=a((3, 3, nh, c), 0.05),
                bg=a((c,), 0.1), wb=a((3, 3, nh, c), 0.05), bb=a((c,), 0.1),
                wc=a((ksize, ksize, c, cout), 0.05), bc=a((cout,), 0.1))
    res = a((b, h, w, cout)) if residual else None
    return arrs, res


def _compare(arrs, res, pre_act, drop_bias=False):
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("wg", "wb", "wc"):                       # HWIO -> OIHW
        t[k] = t[k].permute(3, 2, 0, 1)
    if drop_bias:
        j["bc"] = t["bc"] = None
    order = ("x", "noise", "nscale", "actv", "wg", "bg", "wb", "bb", "wc", "bc")
    want = sb.fused_spade_conv(*(j[k] for k in order), pre_act=pre_act,
                               residual=None if res is None else jnp.asarray(res))
    before = tsb.spade_conv_unit.launches
    got = tsb.spade_conv_unit(pre_act, *(t[k] for k in order),
                              None if res is None else torch.from_numpy(res))
    assert tsb.spade_conv_unit.launches == before      # no kernel on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("ksize", [3, 1])
@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
def test_unit_matches_pallas(ksize, pre_act):
    _compare(*_inputs(ksize=ksize), pre_act)


@pytest.mark.parametrize("ksize", [3, 1])
def test_unit_residual(ksize):
    _compare(*_inputs(ksize=ksize, residual=True), "leaky0.2")


def test_unit_no_bias():
    _compare(*_inputs(ksize=1, residual=True), None, drop_bias=True)


@pytest.mark.parametrize("h", [8, 16])
def test_unit_edge_rows(h):
    _compare(*_inputs(h=h, residual=True), "leaky0.2")


def test_unit_wide_channels():
    _compare(*_inputs(c=40, cout=24), "leaky0.2")


def test_gate_admits_up3_up4_only():
    """At 1024x768 the gate admits the JAX gate's blocks (up_3 512x384 and
    up_4 1024x768) on a CUDA device in bf16; never up_2 (256x192, w % 128)
    or a smaller block, another dtype (f32 included: the JAX gate takes
    bf16 only), or the CPU."""
    gate = tsb.fused_spade_conv_eligible
    for h, w in ((512, 384), (1024, 768)):
        assert gate(h, w, 128, torch.bfloat16, "cuda")
        assert not gate(h, w, 128, torch.float32, "cuda")
        assert not gate(h, w, 128, torch.bfloat16, "cpu")
        assert not gate(h, w, 128, torch.float16, "cuda")
    for h, w in ((256, 192), (128, 96), (64, 48)):
        assert not gate(h, w, 128, torch.bfloat16, "cuda")
