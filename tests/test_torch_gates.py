"""The port's four kernel gates give the JAX gates' answers, on the CPU.

The JAX gates admit bf16 only: an f32 (or f16) forward never reaches a
Pallas kernel and takes XLA's path. The port's gates follow them: for every
site of the ngf=64 'most' generator's blocks up_1 to up_4 at 1024x768
(each block's unit, each norm, each 3x3 conv), in bf16, f32 and f16, the
port's gate asked for a CUDA device answers as the JAX gate asked as on a
TPU (``jax.default_backend`` patched to "tpu", interpret mode off), with
its switch (``fast_spade``, ``fast_conv``, the small-channel ``_VIEWS``)
on on both sides. Nothing of the JAX package is edited for it.
"""

import importlib

import jax
import jax.numpy as jnp
import pytest
import torch

from hrviton_tpu_torch.config import SPADEGenConfig
from hrviton_tpu_torch.models.spade import SPADEGenerator
from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.ops import spade_block as tsb
from hrviton_tpu_torch.ops import spade_fused as tsf

jsb = importlib.import_module("hrviton_tpu.ops.spade_block")
jsf = importlib.import_module("hrviton_tpu.ops.spade_fused")
jc3 = importlib.import_module("hrviton_tpu.ops.conv3x3")

_BLOCKS = ("up_1", "up_2", "up_3", "up_4")
_DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
           "f32": (torch.float32, jnp.float32),
           "f16": (torch.float16, jnp.float16)}


def _sites():
    """(block h, w; norms' NHWC shapes; 3x3 convs' (x NHWC, w OIHW)) of the
    blocks up_1..up_4 at 1024x768, batch 4."""
    gen = SPADEGenerator(SPADEGenConfig(ngf=64), device="meta")
    n_blocks = len(gen.block_names)
    blocks, norms, convs = [], [], []
    for i, name in enumerate(gen.block_names):
        h, w = (s // 2 ** (n_blocks - 1 - i) for s in (1024, 768))
        if name not in _BLOCKS:
            continue
        blocks.append((h, w))
        for sub, mod in getattr(gen, name).named_children():
            if sub.startswith("norm"):
                c = mod.noise_scale.shape[0]
                norms.append((4, h, w, c))
                convs.append(((4, h, w, 7), tuple(mod.conv_shared.weight.shape)))
                for conv in (mod.conv_gamma, mod.conv_beta):
                    convs.append(((4, h, w, 128), tuple(conv.weight.shape)))
            elif tuple(mod.weight.shape[-2:]) == (3, 3):
                convs.append(((4, h, w, mod.weight.shape[1]),
                              tuple(mod.weight.shape)))
    return blocks, norms, convs


@pytest.fixture
def jax_as_on_tpu(monkeypatch):
    for mod in (jsb, jsf, jc3):
        monkeypatch.setattr(mod, "_INTERPRET", False)
    monkeypatch.setattr(jc3, "_TH", 8)
    monkeypatch.setattr(jc3, "_VTH", 8)
    monkeypatch.setattr(jc3, "_VIEWS", True)
    monkeypatch.setattr(tc3, "_VIEWS", True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _hwio(ws):
    return (ws[2], ws[3], ws[1], ws[0])


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("gate", ["unit", "modulate", "wide", "small"])
def test_port_gate_answers_as_the_jax_gate(jax_as_on_tpu, gate, dtype):
    tdt, jdt = _DTYPES[dtype]
    blocks, norms, convs = _sites()
    one = ((1, 1), (1, 1))
    if gate == "unit":
        asks = [((h, w), lambda s: tsb.fused_spade_conv_eligible(
                    *s, 128, tdt, "cuda"),
                 lambda s: jsb.fused_spade_conv_eligible(*s, 128, jdt))
                for h, w in blocks]
    elif gate == "modulate":
        asks = [(x, lambda s: tsf.fused_spade_eligible(s, 128, tdt, "cuda"),
                 lambda s: jsf.fused_spade_eligible(s, 128, jdt))
                for x in norms]
    elif gate == "wide":
        asks = [((x, ws), lambda s: tc3.conv3x3_eligible(
                    s[0], s[1], *one, tdt, "cuda"),
                 lambda s: jc3.conv3x3_eligible(s[0], _hwio(s[1]), *one, jdt))
                for x, ws in convs]
    else:
        asks = [((x, ws), lambda s: tc3._views_eligible(
                    s[0], s[1], *one, tdt, "cuda"),
                 lambda s: jc3._views_eligible(s[0], _hwio(s[1]), *one, jdt))
                for x, ws in convs]
    with tsf.fast_spade(True), jsf.fast_spade(True), \
            tc3.fast_conv(True), jc3.fast_conv(True):
        got = [port(site) for site, port, _ in asks]
        want = [ref(site) for site, _, ref in asks]
    assert got == want
    # bf16 opens each gate somewhere at 1024x768; no other dtype opens one
    assert any(got) == (dtype == "bf16"), gate
