"""LPIPS head training (``hrviton_tpu_torch/losses/lpips_train.py``) against
``hrviton_tpu/losses/lpips_train.py`` on the CPU, f32.

* ``Dist2LogitLayer`` and ``bce_ranking_loss`` on random variables shared
  through ``load_jax_variables``: values, and the gradients of the loss
  with respect to the rank net's parameters and both distances, within
  1e-5 of max|ref| (a gradient within 1e-5 of its max|ref| per tensor);
  a saturated logit: log(eps) with the default eps, the -100 clamp
  without it, on both sides;
* the heads' dropout: keep rate 0.5 +- 0.02, kept values doubled, the
  masks reproducible from the generator and independent between the two
  forwards of a step;
* two ``LPIPSHeadTrainer`` steps (alex, 64x64, batch 4) against the JAX
  trainer's ``train_step`` from the same variables, with the dropout the
  identity on both sides (pytest's monkeypatch of the port's ``_dropout``
  and of ``flax.linen.Dropout`` for the test's length): loss and acc within
  1e-5 relative, the heads and the rank net within 1e-5 of max|ref| after
  each step, every head kernel >= 0 (the clamp), the backbone untouched
  and without optimizer state; the lr decay, a third step after it, and
  ``trained_variables`` scored through both packages' LPIPSModel.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.losses import lpips_train as jlt
from hrviton_tpu.losses.lpips import LPIPSModel as JLPIPSModel
from hrviton_tpu_torch.convert import export_jax_variables, load_jax_variables
from hrviton_tpu_torch.losses import lpips as tlpips
from hrviton_tpu_torch.losses import lpips_train as tlt
from test_torch_support import random_variables

torch.set_num_threads(2)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + 1e-9, (err, want)


def _rank_pair(seed=0):
    jm = jlt.Dist2LogitLayer()
    v = random_variables(jm, jax.random.PRNGKey(0), jnp.zeros((1,)),
                         jnp.zeros((1,)), seed=seed)
    tm = tlt.Dist2LogitLayer(device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm


def test_dist2logit_and_bce_values_and_gradients():
    jm, v, tm = _rank_pair()
    rng = np.random.default_rng(1)
    d0 = rng.random(8, dtype=np.float32) * 0.5
    d1 = rng.random(8, dtype=np.float32) * 0.5
    judge = rng.random(8, dtype=np.float32)

    def jloss(params, a, b):
        logit = jm.apply({"params": params}, a, b)
        return jlt.bce_ranking_loss(logit, judge), logit

    (want, want_logit), (gp, ga, gb) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(v["params"], d0, d1)
    a = torch.from_numpy(d0).requires_grad_(True)
    b = torch.from_numpy(d1).requires_grad_(True)
    logit = tm(a, b)
    loss = tlt.bce_ranking_loss(logit, torch.from_numpy(judge))
    _close(logit, want_logit)
    _close(loss, want)
    grads = torch.autograd.grad(loss, [a, b] + list(tm.parameters()))
    _close(grads[0], ga)
    _close(grads[1], gb)
    port_tree = export_jax_variables(tm)["params"]
    names = [n for n, _ in tm.named_parameters()]
    for name, g in zip(names, grads[2:]):
        layer, leaf = name.split(".")
        want_g = gp[layer]["conv"]["kernel" if leaf == "weight" else "bias"]
        if leaf == "weight":
            g = g.permute(2, 3, 1, 0)                # OIHW -> HWIO
        _close(g, want_g)
    assert set(port_tree) == set(v["params"])


def test_bce_clamps_the_log_at_minus_100():
    logit = np.array([0.0, 1.0, 0.5], np.float32)
    per = np.array([1.0, 0.0, 0.5], np.float32)
    for eps, saturated in ((1e-12, -np.log(1e-12)), (0.0, 100.0)):
        want = jlt.bce_ranking_loss(jnp.asarray(logit), jnp.asarray(per), eps)
        got = tlt.bce_ranking_loss(torch.from_numpy(logit),
                                   torch.from_numpy(per), eps)
        _close(got, want)
        assert float(got) == pytest.approx((2 * saturated + np.log(2)) / 3,
                                           rel=1e-5)


def test_dropout_statistics():
    t = torch.ones(8, 32, 32, 16)
    a = tlpips._dropout(t, torch.Generator().manual_seed(5))
    b = tlpips._dropout(t, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    c, d = tlpips._dropout(t, g), tlpips._dropout(t, g)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(c, d)                     # the second forward's mask
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    keep = float((a != 0).float().mean())
    assert abs(keep - 0.5) <= 0.02, keep


def _batch(seed, n=4):
    r = np.random.default_rng(seed)
    ref = r.standard_normal((n, 64, 64, 3), np.float32).clip(-1, 1)
    p0 = np.clip(ref + 0.05 * r.standard_normal(ref.shape, np.float32), -1, 1)
    p1 = np.clip(ref + 0.5 * r.standard_normal(ref.shape, np.float32), -1, 1)
    judge = r.random(n, dtype=np.float32)
    return ref, p0, p1, judge


def _heads_and_rank(jt):
    return {**jt.params["model"],
            **{f"rank/{k}": v for k, v in jt.params["rank"].items()}}


def _port_tree(pt):
    heads = export_jax_variables(pt.model)["params"]
    rank = export_jax_variables(pt.rank)["params"]
    return {**{k: v for k, v in heads.items() if k.startswith("lin")},
            **{f"rank/{k}": v for k, v in rank.items()}}


def _compare_trees(port, jax_tree):
    assert set(port) == set(jax_tree)
    for k in port:
        for leaf, want in jax_tree[k]["conv"].items():
            _close(port[k]["conv"][leaf], want)


def test_head_trainer_steps_match_jax(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", lambda *a, **k: (lambda t: t))
    monkeypatch.setattr(tlpips, "_dropout", lambda t, generator: t)
    jt = jlt.LPIPSHeadTrainer(net="alex", lr=1e-3, image_hw=(64, 64),
                              rng=jax.random.PRNGKey(1))
    variables = {"params": {**jax.tree_util.tree_map(np.asarray, jt._frozen),
                            **jax.tree_util.tree_map(np.asarray,
                                                     jt.params["model"])}}
    rank = jax.tree_util.tree_map(np.asarray, jt.params["rank"])
    pt = tlt.LPIPSHeadTrainer(net="alex", lr=1e-3, variables=variables,
                              device="cpu")
    load_jax_variables(pt.rank, {"params": rank})
    backbone = {k: v.clone() for k, v in pt.model.alex.state_dict().items()}
    assert len(pt.opt.opt.param_groups[0]["params"]) == 5 + 6
    # the kaiming-initialized heads start with negative weights to clamp
    assert min(float(h.weight.detach().min()) for h in pt.heads) < 0

    for step in range(2):
        batch = _batch(10 + step)
        jl, ja = jt.train_step(*batch)
        tl, ta = pt.train_step(*batch)
        assert tl == pytest.approx(jl, rel=1e-5)
        assert ta == pytest.approx(ja, rel=1e-5)
        _compare_trees(_port_tree(pt), _heads_and_rank(jt))
        assert all(float(h.weight.detach().min()) >= 0.0 for h in pt.heads)
    for k, v in pt.model.alex.state_dict().items():
        assert torch.equal(v, backbone[k]), k
    assert all(not p.requires_grad for p in pt.model.alex.parameters())

    assert pt.update_learning_rate(10) == pytest.approx(
        jt.update_learning_rate(10)) == pytest.approx(1e-3 - 1e-4)
    batch = _batch(20)
    assert pt.train_step(*batch)[0] == pytest.approx(jt.train_step(*batch)[0],
                                                     rel=1e-5)
    _compare_trees(_port_tree(pt), _heads_and_rank(jt))

    # the trained heads score through both packages' LPIPSModel
    tv = pt.trained_variables()
    jv = jt.trained_variables()
    assert set(tv["params"]) == set(jv["params"])
    x, y = _batch(30)[:2]
    want = JLPIPSModel(net="alex").apply(jv, x, y)
    scorer = tlpips.LPIPSModel("alex", device="cpu")
    load_jax_variables(scorer, tv)
    with torch.no_grad():
        got = scorer(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, want)


def test_head_trainer_pnet_tune_trains_the_backbone():
    pt = tlt.LPIPSHeadTrainer(net="alex", lr=1e-3, pnet_tune=True,
                              device="cpu")
    before = {k: v.clone() for k, v in pt.model.alex.state_dict().items()}
    loss, acc = pt.train_step(*_batch(40, n=2))
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    moved = [k for k, v in pt.model.alex.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved
    assert all(float(h.weight.detach().min()) >= 0.0 for h in pt.heads)
