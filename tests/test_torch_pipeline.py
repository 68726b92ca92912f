"""The slice end to end: the port's TryOnPipeline / tryon_forward vs the JAX
package's tryon_forward, f32 on the CPU, same random weights and noise.

Small sizes: tocg ngf=8 at 64x64, SPADE ngf=8 'most' at 256x128. Condition
outputs are held at 2e-4 / 1e-3 (as the model tests). The argmax may flip
where two blurred logits tie to f32 rounding, so at most 0.1% of fake_parse
pixels may differ; the rgb is then compared with the port's generator fed
the JAX parse_labels, at 2e-4 / 1e-3.

The generator's kernel configuration (fused_block off, fast_spade and fast_conv on,
the small-channel switch on) goes through the same comparison: the JAX side
runs its three Pallas kernels in interpret mode; the port's gates, which never
open on the CPU, are forced open with the interpret-mode rules so that its
branches run through the wrappers' plain versions.

The default configuration also runs in bf16 on both sides (the JAX bf16
policy: ``bf16_params`` and bf16 inputs; the port built in bf16), with
limits in bf16 ulps of max|ref| (one ulp: 2^-7 * max|ref|) about twice the
differences seen: flows 4 at most and 1 on average, the other condition
outputs 16 and 2. In bf16 the blurred logits tie more often, so up to 2% of
fake_parse may flip; the rgb is compared with the port's generator fed the
JAX labels, 16 and 1.5.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.config import PipelineConfig as JPipelineConfig
from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.config import TOCGConfig as JTOCGConfig
from hrviton_tpu.core.precision import bf16_params
from hrviton_tpu.models import ConditionGenerator as JCondition
from hrviton_tpu.models import SPADEGenerator as JSPADE
from hrviton_tpu.pipelines import tryon_forward as jtryon_forward
from hrviton_tpu_torch import (PipelineConfig, SPADEGenConfig, TOCGConfig,
                               TryOnPipeline, load_jax_variables)
from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.ops import spade_fused as tsf
from test_torch_support import (assert_within_ulps, injected_noise,
                                open_port_gates, random_variables)

torch.set_num_threads(1)
FH, FW, CH, CW = 256, 128, 64, 64
_ATOL, _RTOL = 2e-4, 1e-3


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


_KNOBS = dict(fused_block=False, fast_spade=True, fast_conv=True)


@functools.lru_cache(maxsize=None)
def _jax_models(knobs=False):
    """Random JAX variables and jitted applies; the generator's noise draws
    are recorded on its first (tracing) call and reused after. With ``knobs``
    the generator has its kernel configuration (the dispatch knobs on)."""
    rng = np.random.default_rng(3)
    k = jax.random.PRNGKey(0)
    tocg = JCondition(JTOCGConfig(ngf=8))
    tv = random_variables(tocg, k, jnp.zeros((1, CH, CW, 4)),
                          jnp.zeros((1, CH, CW, 16)), train=False, seed=1)
    gen = JSPADE(JSPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW,
                                 remat=False, **(_KNOBS if knobs else {})))
    gv = random_variables(gen, {"params": k, "noise": k},
                          jnp.zeros((1, FH, FW, 9)), jnp.zeros((1, FH, FW, 7)),
                          train=False, seed=2)
    tocg_apply = jax.jit(lambda a, b: tocg.apply(tv, a, b, train=False))
    draws = []

    @jax.jit
    def gen_apply(x, seg):
        with injected_noise(rng) as d:
            out = gen.apply(gv, x, seg, train=False, rngs={"noise": k})
        draws.extend(d)
        return out
    return tv, gv, tocg_apply, gen_apply, draws


@functools.lru_cache(maxsize=None)
def _jax_models_bf16():
    """The default configuration's variables (as ``_jax_models()``) under
    the JAX bf16 policy: jitted applies on ``bf16_params`` of them."""
    tv, gv = _jax_models()[:2]
    rng = np.random.default_rng(3)
    k = jax.random.PRNGKey(0)
    tocg = JCondition(JTOCGConfig(ngf=8))
    gen = JSPADE(JSPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW,
                                 remat=False))
    tv16, gv16 = bf16_params(tv), bf16_params(gv)
    tocg_apply = jax.jit(lambda a, b: tocg.apply(tv16, a, b, train=False))
    draws = []

    @jax.jit
    def gen_apply(x, seg):
        with injected_noise(rng) as d:
            out = gen.apply(gv16, x, seg, train=False, rngs={"noise": k})
        draws.extend(d)
        return out
    return tv, gv, tocg_apply, gen_apply, draws


def test_tryon_forward_bf16_matches_jax():
    tv, gv, tocg_apply, gen_apply, draws = _jax_models_bf16()
    batch = _batch(4)
    jcfg = JPipelineConfig(fine_height=FH, fine_width=FW, cond_height=CH,
                           cond_width=CW)
    want_rgb, want = jtryon_forward(
        tocg_apply, gen_apply,
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in batch.items()}, jcfg)
    assert len(draws) == 23
    pipe = TryOnPipeline(
        PipelineConfig(fine_height=FH, fine_width=FW, cond_height=CH,
                       cond_width=CW),
        TOCGConfig(ngf=8), SPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW),
        device="cpu", dtype=torch.bfloat16)
    load_jax_variables(pipe.tocg, tv)
    load_jax_variables(pipe.generator, gv)
    rgb, got = pipe({k: torch.from_numpy(v) for k, v in batch.items()},
                    noise=draws)
    assert rgb.dtype == torch.bfloat16 and want_rgb.dtype == jnp.bfloat16
    for a, b in zip(got.flow_list, want.flow_list):
        assert_within_ulps(a, b, 4, 1.0)
    for name in ("fake_segmap", "warped_cloth_lr", "warped_clothmask_lr",
                 "fake_parse_gauss", "warped_cloth", "warped_clothmask"):
        assert_within_ulps(getattr(got, name), getattr(want, name), 16, 2.0)
    flips = (got.fake_parse.numpy() != np.asarray(want.fake_parse)).mean()
    assert flips <= 0.02, flips
    gen_in = torch.cat([torch.from_numpy(batch["agnostic"]).bfloat16(),
                        torch.from_numpy(batch["densepose"]).bfloat16(),
                        got.warped_cloth], dim=-1)
    with torch.no_grad():
        rgb_fed = pipe.generator(
            gen_in, torch.from_numpy(np.array(want.parse_labels)), draws)
    assert 0.05 < np.asarray(want_rgb.astype(jnp.float32)).std() < 0.9
    assert_within_ulps(rgb_fed, want_rgb, 16, 1.5)


def _batch(seed):
    rng = np.random.default_rng(seed)
    a = lambda c: rng.standard_normal((2, FH, FW, c)).astype(np.float32)
    return {"cloth": a(3),
            "cloth_mask": rng.uniform(0, 1, (2, FH, FW, 1)).astype(np.float32),
            "parse_agnostic": a(13), "densepose": a(3), "agnostic": a(3)}


def _close(t, j, atol=_ATOL, rtol=_RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("occlusion", [False, True])
def test_tryon_forward_matches_jax(occlusion):
    _check_tryon(occlusion, False)


def test_tryon_forward_with_kernel_knobs_matches_jax(monkeypatch):
    c3 = importlib.import_module("hrviton_tpu.ops.conv3x3")
    sf = importlib.import_module("hrviton_tpu.ops.spade_fused")
    for mod in (c3, sf):
        monkeypatch.setattr(mod, "_INTERPRET", True)
        monkeypatch.setattr(mod, "_TH", 4)
    monkeypatch.setattr(c3, "_VTH", 4)
    monkeypatch.setattr(c3, "_VIEWS", True)
    asked = open_port_gates(monkeypatch, ("fast_spade", "fast_conv", "views"))
    launches = lambda: (tsf.fused_spade_modulate.launches,
                        tc3.conv3x3_wide.launches, tc3.conv3x3_small.launches)
    before = launches()
    _check_tryon(False, True)
    # up_0 .. up_4's norms twice (pipeline, then generator fed the JAX labels)
    assert asked.count("modulate") == 30 and asked.count("small") == 8
    assert "wide" in asked
    assert launches() == before                          # no kernel on the CPU
    assert not tc3.fast_conv_enabled() and not tsf.fast_spade_enabled()


def _check_tryon(occlusion, knobs):
    tv, gv, tocg_apply, gen_apply, draws = _jax_models(knobs)
    batch = _batch(4)
    jcfg = JPipelineConfig(fine_height=FH, fine_width=FW, cond_height=CH,
                           cond_width=CW, occlusion=occlusion)
    want_rgb, want = jtryon_forward(
        tocg_apply, gen_apply, {k: jnp.asarray(v) for k, v in batch.items()},
        jcfg)
    assert len(draws) == 23

    pipe = TryOnPipeline(
        PipelineConfig(fine_height=FH, fine_width=FW, cond_height=CH,
                       cond_width=CW, occlusion=occlusion),
        TOCGConfig(ngf=8),
        SPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW,
                       **(_KNOBS if knobs else {})),
        device="cpu")
    load_jax_variables(pipe.tocg, tv)
    load_jax_variables(pipe.generator, gv)
    rgb, got = pipe({k: torch.from_numpy(v) for k, v in batch.items()},
                    noise=draws)

    for a, b in zip(got.flow_list, want.flow_list):
        _close(a, b)
    for name in ("fake_segmap", "warped_cloth_lr", "warped_clothmask_lr",
                 "fake_parse_gauss"):
        _close(getattr(got, name), getattr(want, name))
    flips = (got.fake_parse.numpy() != np.asarray(want.fake_parse)).mean()
    assert flips <= 1e-3, flips
    same = got.fake_parse.numpy() == np.asarray(want.fake_parse)
    np.testing.assert_array_equal(got.parse_labels.numpy()[same],
                                  np.asarray(want.parse_labels)[same])
    np.testing.assert_array_equal(got.parse7.numpy()[same],
                                  np.asarray(want.parse7)[same])
    _close(got.warped_cloth, want.warped_cloth)
    _close(got.warped_clothmask, want.warped_clothmask)

    gen_in = torch.cat([torch.from_numpy(batch["agnostic"]),
                        torch.from_numpy(batch["densepose"]),
                        got.warped_cloth], dim=-1)
    with torch.no_grad():
        rgb_fed = pipe.generator(
            gen_in, torch.from_numpy(np.array(want.parse_labels)), draws)
    assert 0.05 < np.asarray(want_rgb).std() < 0.9     # tanh not saturated
    _close(rgb_fed, want_rgb)
    if flips == 0:
        torch.testing.assert_close(rgb, rgb_fed, atol=0, rtol=0)
