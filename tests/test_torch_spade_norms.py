"""The SPADE norm kinds 'aliasbatch' and 'aliasmask' and MaskNorm: the port
(``hrviton_tpu_torch/models/spade.py``) against ``hrviton_tpu/models/
spade.py`` on the CPU, f32, on random variables shared through
``load_jax_variables`` and the JAX apply's own noise draws (injected).

* ``MaskNorm``: values and the gradient with respect to x against
  ``jax.grad``, with an empty foreground and an empty background among the
  samples; no gradient reaches the mask on either side;
* ``SPADENorm`` 'aliasbatch': training mode (the batch's statistics, the
  running ones staged and written by ``commit_state``) against the JAX
  apply with ``mutable=['batch_stats']``, and eval mode (the running
  statistics); 'aliasmask' with a misalign mask;
* ``SPADEResBlock`` with ``use_mask_norm`` (label_nc + 1, every norm
  'aliasmask') and a misalign mask at a coarser scale, resized nearest;
* ``SPADEGenerator`` 'spectralaliasbatch' ('more', ngf 8) with ``train``
  True (output and every running statistic after ``commit_state``) and
  False; and remat on and off equal bit for bit in a training forward and
  backward, the staged statistics included;
* the gates: with every kernel gate forced open, an alias kind other than
  'aliasinstance' (or a misalign mask) reaches neither the fused
  modulation nor the fused unit, and the s2d domain refuses it, as the JAX
  gates do; 'aliasinstance' reaches both.

Limits: 1e-5 x max|ref| for the norms and the block, the generator's rgb
2e-4 absolute / 1e-3 relative (tests/test_torch_models.py's), running
statistics 1e-5 x max|ref|.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.models import spade as jspade
from hrviton_tpu_torch.config import SPADEGenConfig
from hrviton_tpu_torch.convert import export_jax_variables, load_jax_variables
from hrviton_tpu_torch.models import spade as tspade
from hrviton_tpu_torch.nn.layers import commit_state, drop_state
from test_torch_support import injected_noise, random_variables

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


def _close(got, want, rel=1e-5, atol=0.0):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + atol, (err, rel)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _mask(rng, b, h, w):
    m = (rng.random((b, h, w, 1)) > 0.6).astype(np.float32)
    m[0] = 0.0                       # an empty foreground
    m[1] = 1.0                       # an empty background
    return m


def test_mask_norm_values_and_gradients():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 7, 5)).astype(np.float32) * 2 + 0.5
    m = _mask(rng, 4, 9, 7)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jm = jspade.MaskNorm()

    def f(x_, m_):
        return jnp.sum(jm.apply({}, x_, m_) * g)

    want = jm.apply({}, x, m)
    gx, gm = jax.grad(f, argnums=(0, 1))(x, m)
    assert float(jnp.abs(gm).max()) == 0.0
    tx = _nchw(x).requires_grad_(True)
    tm = _nchw(m).requires_grad_(True)
    got = tspade.MaskNorm()(tx, tm)
    _close(_nhwc(got), want)
    (got * _nchw(g)).sum().backward()
    _close(_nhwc(tx.grad), gx)
    assert tm.grad is None


def _norm_pair(kind, nc=8, label_nc=7, hw=(12, 10), b=4):
    jm = jspade.SPADENorm(nc, label_nc, norm_type=kind)
    z = jnp.zeros((1, *hw, nc))
    zs = jnp.zeros((1, *hw, label_nc))
    zm = jnp.zeros((1, *hw, 1)) if kind == "aliasmask" else None
    k = jax.random.PRNGKey(0)
    v = random_variables(jm, {"params": k, "noise": k}, z, zs, zm,
                         train=False, seed=3)
    tm = tspade.SPADENorm(nc, label_nc, kind, device="cpu")
    load_jax_variables(tm, v)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, *hw, nc)).astype(np.float32)
    seg = rng.standard_normal((b, *hw, label_nc)).astype(np.float32)
    return jm, v, tm, x, seg, rng


@pytest.mark.parametrize("train", [True, False])
def test_spade_norm_aliasbatch(train):
    jm, v, tm, x, seg, _ = _norm_pair("aliasbatch")
    k = jax.random.PRNGKey(1)
    with injected_noise(np.random.default_rng(5)) as draws:
        if train:
            want, new = jm.apply(v, x, seg, None, True, rngs={"noise": k},
                                 mutable=["batch_stats"])
        else:
            want = jm.apply(v, x, seg, None, False, rngs={"noise": k})
    assert len(draws) == 1
    got = tm(_nchw(x), _nchw(seg), tspade.noise_source(draws, "cpu"),
             train=train)
    _close(_nhwc(got), want)
    assert tm.param_free_norm.weight is None        # affine=False
    bn = tm.param_free_norm
    before = (bn.running_mean.clone(), bn.running_var.clone())
    commit_state(tm)
    if train:
        stats = new["batch_stats"]["param_free_norm"]
        _close(bn.running_mean, stats["mean"])
        _close(bn.running_var, stats["var"])
        assert not torch.equal(bn.running_mean, before[0])
    else:
        assert torch.equal(bn.running_mean, before[0])
        assert torch.equal(bn.running_var, before[1])
    # the statistics travel with the JAX variable tree
    tree = export_jax_variables(tm)
    assert set(tree["batch_stats"]["param_free_norm"]) == {"mean", "var"}


def test_spade_norm_aliasmask():
    jm, v, tm, x, seg, rng = _norm_pair("aliasmask")
    m = _mask(rng, *x.shape[:3])
    k = jax.random.PRNGKey(1)
    with injected_noise(np.random.default_rng(5)) as draws:
        want = jm.apply(v, x, seg, m, True, rngs={"noise": k})
    got = tm(_nchw(x), _nchw(seg), tspade.noise_source(draws, "cpu"),
             misalign_mask=_nchw(m), train=True)
    _close(_nhwc(got), want)


def test_spade_resblock_mask_norm():
    cin, cout, label_nc = 12, 8, 7
    jb = jspade.SPADEResBlock(cin, cout, norm_g="spectralaliasinstance",
                              gen_semantic_nc=label_nc, use_mask_norm=True)
    h, w = 16, 12
    k = jax.random.PRNGKey(0)
    v = random_variables(jb, {"params": k, "noise": k},
                         jnp.zeros((1, h, w, cin)),
                         jnp.zeros((1, h, w, label_nc + 1)),
                         jnp.zeros((1, h, w, 1)), False, seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    seg = rng.standard_normal((2, h // 2, w // 2, label_nc + 1)
                              ).astype(np.float32)
    m = (rng.random((2, h // 4, w // 4, 1)) > 0.5).astype(np.float32)
    with injected_noise(np.random.default_rng(8)) as draws:
        want = jb.apply(v, x, seg, m, False, rngs={"noise": k})
    assert len(draws) == 3
    tb = tspade.SPADEResBlock(cin, cout, norm_g="spectralaliasinstance",
                              gen_semantic_nc=label_nc, use_mask_norm=True,
                              device="cpu")
    assert tb.norm_0.kind == "mask"
    assert tb.norm_0.conv_shared.weight.shape[1] == label_nc + 1
    load_jax_variables(tb, v)
    with torch.no_grad():
        got = tb(_nchw(x), _nchw(seg), tspade.noise_source(draws, "cpu"),
                 misalign_mask=_nchw(m))
    _close(_nhwc(got), want)


H, W = 128, 64


def _gen_pair():
    cfg = dict(ngf=8, num_upsampling_layers="more", fine_height=H,
               fine_width=W, norm_g="spectralaliasbatch")
    jg = jspade.SPADEGenerator(JSPADEGenConfig(remat=False, **cfg))
    k = jax.random.PRNGKey(0)
    v = random_variables(jg, {"params": k, "noise": k},
                         jnp.zeros((1, H, W, 9)), jnp.zeros((1, H, W, 7)),
                         train=False, seed=9)
    assert "batch_stats" in v
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, H, W, 9)).astype(np.float32)
    labels = rng.integers(0, 7, (2, H, W)).astype(np.int32)
    return cfg, jg, v, x, labels


@pytest.mark.parametrize("train", [True, False])
def test_spade_generator_aliasbatch(train):
    cfg, jg, v, x, labels = _gen_pair()
    k = jax.random.PRNGKey(1)
    with injected_noise(np.random.default_rng(11)) as draws:
        out = jax.jit(lambda v_, x_, l_: jg.apply(
            v_, x_, l_, train=train, rngs={"noise": k},
            mutable=["batch_stats"] if train else False))(v, x, labels)
    want, new = out if train else (out, None)
    port = tspade.SPADEGenerator(SPADEGenConfig(**cfg), device="cpu")
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(labels), draws,
                   train=train)
    _close(got, want, rel=1e-3, atol=2e-4)
    commit_state(port)
    stats = export_jax_variables(port)["batch_stats"]
    ref = new["batch_stats"] if train else v["batch_stats"]
    n = 0
    for block, norms in ref.items():
        for norm, sub in norms.items():
            for leaf in ("mean", "var"):
                _close(torch.from_numpy(stats[block][norm]["param_free_norm"][leaf]),
                       sub["param_free_norm"][leaf])
                n += 1
    assert n == 2 * 20                    # 7 blocks, 20 norms ('more')


def test_generator_remat_with_batch_statistics():
    """remat on / off: the same rgb, the same gradients and the same staged
    statistics, bit for bit (the recompute reads the unchanged buffers)."""
    cfg, _, v, x, labels = _gen_pair()
    outs = []
    for remat in (False, True):
        port = tspade.SPADEGenerator(SPADEGenConfig(remat=remat, **cfg),
                                     device="cpu")
        load_jax_variables(port, v)
        noise = torch.Generator().manual_seed(12)
        rgb = port(torch.from_numpy(x), torch.from_numpy(labels), noise,
                   train=True, update_sn=True)
        grads = torch.autograd.grad(rgb.square().mean(),
                                    list(port.parameters()), allow_unused=True)
        commit_state(port)
        outs.append((rgb.detach(), grads,
                     [b.clone() for b in port.buffers()]))
    (r0, g0, b0), (r1, g1, b1) = outs
    assert torch.equal(r0, r1)
    assert sum(g is not None for g in g0) > 100
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


@pytest.mark.parametrize("kind", ["aliasinstance", "aliasbatch", "aliasmask"])
def test_gates_refuse_the_alias_kinds(kind, monkeypatch):
    """Every gate forced open: only 'aliasinstance' without a misalign mask
    reaches the fused modulation (SPADENorm) and the fused unit
    (SPADEResBlock); the s2d domain refuses every other kind on both
    sides."""
    calls = []
    monkeypatch.setattr(tspade, "fused_spade_eligible",
                        lambda *a: calls.append("gate_mod") or True)
    monkeypatch.setattr(tspade, "fused_spade_conv_eligible",
                        lambda *a: calls.append("gate_unit") or True)
    real_mod, real_unit = tspade.fused_spade_modulate, tspade.spade_conv_unit
    monkeypatch.setattr(tspade, "fused_spade_modulate",
                        lambda *a: calls.append("modulate") or real_mod(*a))
    monkeypatch.setattr(tspade, "spade_conv_unit",
                        lambda *a: calls.append("unit") or real_unit(*a))
    mask = kind == "aliasmask"
    label_nc = 8 if mask else 7
    x = torch.randn(2, 8, 8, 6, generator=torch.Generator().manual_seed(0))
    seg = torch.randn(2, label_nc, 8, 6)
    m = (torch.rand(2, 1, 8, 6) > 0.5).float() if mask else None
    draw = tspade.noise_source(torch.Generator().manual_seed(1), "cpu")

    norm = tspade.SPADENorm(8, label_nc, kind, device="cpu")
    with torch.no_grad():
        norm(x, seg, draw, misalign_mask=m, train=True)
    block = tspade.SPADEResBlock(8, 4, "spectral" + kind, fused=True,
                                 use_mask_norm=mask, device="cpu")
    with torch.no_grad():
        block(x, seg, draw, misalign_mask=m, train=True)
    drop_state(block)
    fused = {"modulate", "unit"} & set(calls)
    assert fused == ({"modulate", "unit"} if kind == "aliasinstance" else
                     set()), calls

    jn = jspade.SPADENorm(8, 7, norm_type=kind)
    xs = jnp.zeros((1, 4, 3, 32))
    ss = jnp.zeros((1, 4, 3, 28))
    if kind == "aliasinstance":
        assert norm.kind == "instance"
        return
    with pytest.raises(NotImplementedError, match="instance only"):
        jn.init({"params": jax.random.PRNGKey(0),
                 "noise": jax.random.PRNGKey(0)}, xs, ss, None, True,
                s2d=True)
    with pytest.raises(ValueError, match="instance norm only"):
        norm(torch.zeros(1, 32, 4, 3), torch.zeros(1, 4 * label_nc, 4, 3),
             draw, s2d=True)
