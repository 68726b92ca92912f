"""The slice end to end: the port's TryOnPipeline / tryon_forward vs the JAX
package's tryon_forward, f32 on the CPU, same random weights and noise.

Small sizes: tocg ngf=8 at 64x64, SPADE ngf=8 'most' at 256x128. Condition
outputs are held at 2e-4 / 1e-3 (as the model tests). The argmax may flip
where two blurred logits tie to f32 rounding, so at most 0.1% of fake_parse
pixels may differ; the rgb is then compared with the port's generator fed
the JAX parse_labels, at 2e-4 / 1e-3.
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
from hrviton_tpu.models import ConditionGenerator as JCondition
from hrviton_tpu.models import SPADEGenerator as JSPADE
from hrviton_tpu.pipelines import tryon_forward as jtryon_forward
from hrviton_tpu_torch import (PipelineConfig, SPADEGenConfig, TOCGConfig,
                               TryOnPipeline, load_jax_variables)
from test_torch_support import injected_noise, random_variables

torch.set_num_threads(1)
FH, FW, CH, CW = 256, 128, 64, 64
_ATOL, _RTOL = 2e-4, 1e-3


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


@functools.lru_cache(maxsize=None)
def _jax_models():
    """Random JAX variables and jitted applies; the generator's noise draws
    are recorded on its first (tracing) call and reused after."""
    rng = np.random.default_rng(3)
    k = jax.random.PRNGKey(0)
    tocg = JCondition(JTOCGConfig(ngf=8))
    tv = random_variables(tocg, k, jnp.zeros((1, CH, CW, 4)),
                          jnp.zeros((1, CH, CW, 16)), train=False, seed=1)
    gen = JSPADE(JSPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW,
                                 remat=False))
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
    tv, gv, tocg_apply, gen_apply, draws = _jax_models()
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
        TOCGConfig(ngf=8), SPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW),
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
