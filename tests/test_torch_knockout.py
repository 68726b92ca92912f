"""The knockout attribution (timing only), on the CPU.

The port's plain knocked unit (``ops/spade_block.py``, ``knock=``) against
the JAX kernel under the same ``_knock`` (Pallas in interpret mode, 4 rows a
step), f32, 1e-4 as in test_torch_spade_block.py; the port's generator
under ``gen_knock`` against the JAX generator under the same tag, the fused
dispatch open on both sides (the JAX interpret-mode gate's rules), at the
generator parity limits of test_torch_models.py; the empty set is the
production output bit for bit; the knock set keys the captured entry points
(the CPU stand-in of test_torch_graphs.py). The tools' mains run in
test_torch_knockout_tools.py. The knock variants of the CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py phase 12).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.models import SPADEGenerator as JSPADE
from hrviton_tpu_torch import SPADEGenConfig
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.models import SPADEGenerator
from hrviton_tpu_torch.models import spade as tspade
from hrviton_tpu_torch.ops import spade_block as tsb
from hrviton_tpu_torch.pipelines import tryon
from test_torch_graphs import _Rerun, _batch, _pipeline
from test_torch_support import injected_noise, random_variables

sb = importlib.import_module("hrviton_tpu.ops.spade_block")
jspade = importlib.import_module("hrviton_tpu.models.spade")
torch.set_num_threads(2)

# every tag set of the unit but actv_dma (the output is undefined there)
UNIT_SETS = [("stats",), ("prod_dots",), ("prod_rolls",), ("normalize",),
             ("modulate",), ("cons_dots",), ("cons_rolls",),
             ("prod_rolls", "cons_rolls")]
_ATOL, _RTOL = 2e-4, 1e-3          # test_torch_models.py's generator limits


@pytest.fixture(autouse=True)
def _interpret_small_tiles(monkeypatch):
    monkeypatch.setattr(sb, "_INTERPRET", True)
    monkeypatch.setattr(sb, "_TH", 4)


def _unit_inputs(ksize, residual, b=2, h=12, w=128, c=16, cout=8, nh=128,
                 seed=0):
    rng = np.random.default_rng(seed)

    def a(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    # x's channel means and scales well away from 0 and 1, so that the
    # statistics and the normalize step show in the output
    x = a((b, h, w, c)) * (1 + 2 * rng.uniform(0, 1, c)) + 3 * a((c,))
    arrs = dict(x=x.astype(np.float32), noise=a((b, h, w, 1)),
                nscale=a((c,), 0.1),
                actv=a((b, h, w, nh)), wg=a((3, 3, nh, c), 0.05),
                bg=a((c,), 0.1), wb=a((3, 3, nh, c), 0.05), bb=a((c,), 0.1),
                wc=a((ksize, ksize, c, cout), 0.05), bc=a((cout,), 0.1))
    return arrs, (a((b, h, w, cout)) if residual else None)


_ORDER = ("x", "noise", "nscale", "actv", "wg", "bg", "wb", "bb", "wc", "bc")


def _torch_args(arrs):
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("wg", "wb", "wc"):                       # HWIO -> OIHW
        t[k] = t[k].permute(3, 2, 0, 1)
    return [t[k] for k in _ORDER]


def _unit(arrs, res, pre_act, knock):
    want = sb.fused_spade_conv(*(jnp.asarray(arrs[k]) for k in _ORDER),
                               pre_act=pre_act, _knock=knock,
                               residual=None if res is None else jnp.asarray(res))
    counters = [*tsb.knock_counters.values(), *tsb.knock_production.values()]
    counts = [c.launches for c in counters]
    before = tsb.spade_conv_unit.launches
    got = tsb.spade_conv_unit(pre_act, *_torch_args(arrs),
                              None if res is None else torch.from_numpy(res),
                              knock=knock)
    assert tsb.spade_conv_unit.launches == before      # no kernel on the CPU
    assert [c.launches for c in counters] == counts
    return got, np.asarray(want)


@pytest.mark.parametrize("knock", UNIT_SETS, ids="+".join)
@pytest.mark.parametrize("ksize", [3, 1])
@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
def test_knocked_unit_matches_pallas(knock, ksize, pre_act):
    arrs, res = _unit_inputs(ksize, residual=ksize == 3)
    got, want = _unit(arrs, res, pre_act, knock)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # every knock changes the output (a stub that computes the production
    # result would attribute nothing), but the 1x1 consumer's tags
    if ksize == 3 or not set(knock) <= {"cons_dots", "cons_rolls"}:
        prod = tsb.spade_conv_unit(pre_act, *_torch_args(arrs),
                                   None if res is None else torch.from_numpy(res))
        assert not torch.allclose(got, prod, atol=1e-3)


@pytest.mark.parametrize("ksize", [3, 1])
def test_actv_dma_keeps_the_shape(ksize):
    """actv_dma leaves the output undefined in both packages: shape only."""
    arrs, res = _unit_inputs(ksize, residual=False)
    got, want = _unit(arrs, res, "leaky0.2", ("actv_dma",))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()


def test_generator_tags_pass_through_the_unit():
    """A generator tag reaching the unit changes nothing there, as in the
    JAX kernel; an unknown tag raises."""
    arrs, res = _unit_inputs(3, residual=True)
    args = _torch_args(arrs) + [torch.from_numpy(res)]
    prod = tsb.spade_conv_unit("leaky0.2", *args)
    for tag in tsb.GENERATOR_KNOCKS:
        assert torch.equal(tsb.spade_conv_unit("leaky0.2", *args, knock=(tag,)),
                           prod)
    with pytest.raises(ValueError, match="unknown knock"):
        tsb.spade_conv_unit("leaky0.2", *args, knock=("noise",))
    with pytest.raises(ValueError, match="unknown knock"):
        with tspade.gen_knock(("stat",)):
            pass
    assert tspade._GEN_KNOCK == frozenset()


def test_cons_dots_needs_cout_within_c():
    arrs, res = _unit_inputs(3, residual=False, c=8, cout=16)
    with pytest.raises(ValueError, match="cout <= C"):
        tsb.spade_conv_unit(None, *_torch_args(arrs), None, knock=("cons_dots",))


# ------------------------------------------------------------ the generator

H, W = 256, 128          # up_4 (256 x 128) is the block both gates admit


def _jax_generator(knock, rng_seed=1):
    rng = np.random.default_rng(rng_seed)
    m = JSPADE(JSPADEGenConfig(ngf=8, num_upsampling_layers="most",
                               fine_height=H, fine_width=W, remat=False,
                               fused_block=True))
    k = jax.random.PRNGKey(0)
    v = random_variables(m, {"params": k, "noise": k},
                         jnp.zeros((1, H, W, 9)), jnp.zeros((1, H, W, 7)),
                         train=False)
    x = rng.standard_normal((2, H, W, 9)).astype(np.float32)
    labels = rng.integers(0, 7, (2, H, W)).astype(np.int32)
    with injected_noise(rng) as draws, jspade.gen_knock(knock):
        out = jax.jit(lambda v_, x_, l_: m.apply(
            v_, x_, l_, train=False, rngs={"noise": k}))(v, x, labels)
    return v, x, labels, draws, np.asarray(out)


def _port_generator(monkeypatch, v):
    calls = []

    def gate(h, w, nh, dtype, device):   # the JAX interpret-mode gate
        ok = h % 4 == 0 and w % 128 == 0 and h > 4 and nh % 128 == 0
        calls.append(ok)
        return ok
    monkeypatch.setattr(tspade, "fused_spade_conv_eligible", gate)
    port = SPADEGenerator(SPADEGenConfig(ngf=8, fine_height=H, fine_width=W,
                                         fused_block=True), device="cpu")
    load_jax_variables(port, v)
    return port, calls


@pytest.mark.parametrize("knock", [(t,) for t in tspade.KNOCKS]
                         + [tspade.KNOCKS, ("normalize",), ("prod_rolls",
                                                            "cons_rolls")],
                         ids="+".join)
def test_generator_knock_matches_jax(monkeypatch, knock):
    v, x, labels, draws, want = _jax_generator(knock)
    port, calls = _port_generator(monkeypatch, v)
    with torch.no_grad(), tspade.gen_knock(knock):
        got = port(torch.from_numpy(x), torch.from_numpy(labels), draws)
    assert tspade._GEN_KNOCK == frozenset()
    assert sum(calls) == 1                   # up_4 went through the unit
    np.testing.assert_allclose(got.numpy(), want, atol=_ATOL, rtol=_RTOL)


def test_empty_knock_is_production_bit_for_bit(monkeypatch):
    v, x, labels, draws, _ = _jax_generator(())
    port, _ = _port_generator(monkeypatch, v)
    args = (torch.from_numpy(x), torch.from_numpy(labels))
    with torch.no_grad():
        prod = port(*args, draws)
        with tspade.gen_knock(()):
            empty = port(*args, draws)
        with tspade.gen_knock(("unit",)):
            knocked = port(*args, draws)
        again = port(*args, draws)
    assert torch.equal(empty, prod) and torch.equal(again, prod)
    assert not torch.equal(knocked, prod)


def test_no_tag_outlives_its_context():
    with tspade.gen_knock(("unit",)):
        with tspade.gen_knock(("stats", "conv_img")):
            assert tspade._GEN_KNOCK == {"stats", "conv_img"}
        assert tspade._GEN_KNOCK == {"unit"}
    assert tspade._GEN_KNOCK == frozenset()
    with pytest.raises(RuntimeError):
        with tspade.gen_knock(("features",)):
            raise RuntimeError("inside")
    assert tspade._GEN_KNOCK == frozenset()


def test_knock_keys_the_captured_pipeline(monkeypatch):
    """Under a knock the pipeline's captured forward records a graph of its
    own; after the context it replays the production graph with no new
    recording, and gives the production output."""
    c = tryon._forward
    rerun = _Rerun(c.fn, weights=c.weights, context=c.context)
    monkeypatch.setattr(tryon, "_forward", rerun)
    pipe = _pipeline()
    batch = _batch(1)
    first, _ = pipe(batch)
    assert rerun.captures == 1
    with tspade.gen_knock(("conv_img",)):
        knocked, _ = pipe(batch)
        pipe(batch)
    assert rerun.captures == 2 and len(rerun.entries) == 2
    after, _ = pipe(batch)
    assert rerun.captures == 2
    assert torch.equal(after, first) and not torch.equal(knocked, first)
    with tspade.gen_knock(("conv_img",)):
        pipe(batch)
    assert rerun.captures == 2


def test_knock_set_is_a_registered_switch():
    cap = graphs.Captured(lambda x: x)
    key = lambda: cap._signature((torch.zeros(2),), {})[0]
    k = key()
    with tspade.gen_knock(("seg_for",)):
        assert key() != k
    assert key() == k
