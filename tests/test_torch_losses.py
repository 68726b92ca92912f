"""The training losses and the optimizer against the JAX package on the CPU.

Each loss of ``hrviton_tpu_torch/losses/`` (gan, matching, tv, seg,
perceptual) on the same numpy inputs as its JAX counterpart: the value and
the gradient (``torch.autograd`` against ``jax.grad``) within 1e-5 x
max(1, |ref|). The VGG loss runs a random VGG19 loaded into both sides
through ``convert.load_jax_variables``. Then Adam and the lambda-decay
schedule against optax on the same gradients at updates 1, 2, 1000 and 1001
(the schedule steps once per 1000 updates): parameters within 1e-6
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hrviton_tpu.losses import gan as jgan
from hrviton_tpu.losses import matching as jmatch
from hrviton_tpu.losses import perceptual as jperc
from hrviton_tpu.losses import seg as jseg
from hrviton_tpu.losses import tv as jtv
from hrviton_tpu.models.backbones import Vgg19Features as JVgg
from hrviton_tpu.train import optim as joptim
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.losses import gan, matching, perceptual, seg, tv
from hrviton_tpu_torch.models.backbones import Vgg19Features
from hrviton_tpu_torch.train import optim
from test_torch_support import random_variables

torch.set_num_threads(1)
_rng = np.random.default_rng(0)


def _a(*shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


def _value_and_grads(jfn, tfn, arrays):
    """(port value, port grads), (JAX value, JAX grads) w.r.t. every array."""
    jv, jg = jax.jit(jax.value_and_grad(lambda *a: jfn(*a), argnums=tuple(
        range(len(arrays)))))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tv_ = tfn(*ts)
    tg = torch.autograd.grad(tv_, ts, allow_unused=True)
    return (tv_, tg), (jv, jg)


def _close(port, ref):
    (tv_, tg), (jv, jg) = port, ref
    jv = float(jv)
    assert abs(float(tv_) - jv) <= 1e-5 * max(1.0, abs(jv)), (float(tv_), jv)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        lim = 1e-5 * max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= lim, (np.abs(a - b).max(), lim)


def _pred(scales=2, n=3, shape=(2, 9, 7, 1)):
    """A multiscale prediction: per scale ``n`` feature maps, logits last."""
    return [[_a(*shape[:3], 4) for _ in range(n - 1)] + [_a(*shape)]
            for _ in range(scales)]


def _unflat(flat, like):
    it = iter(flat)
    return [[next(it) for _ in s] for s in like]


@pytest.mark.parametrize("real", [True, False])
def test_lsgan_loss(real):
    pred = _pred()
    flat = [a for s in pred for a in s]
    _close(*_value_and_grads(
        lambda *a: jgan.lsgan_loss(_unflat(a, pred), real),
        lambda *a: gan.lsgan_loss(_unflat(a, pred), real), flat))


@pytest.mark.parametrize("mode,real,for_d", [
    ("hinge", True, True), ("hinge", False, True), ("hinge", True, False),
    ("ls", True, True), ("ls", False, True), ("original", True, True),
    ("original", False, True), ("w", True, True), ("w", False, True)])
def test_gan_loss(mode, real, for_d):
    pred = _pred()
    flat = [a for s in pred for a in s]
    _close(*_value_and_grads(
        lambda *a: jgan.gan_loss(_unflat(a, pred), real, mode, for_d),
        lambda *a: gan.gan_loss(_unflat(a, pred), real, mode, for_d), flat))


def test_gan_loss_bare_logits():
    """A discriminator without feature maps gives bare logit maps."""
    logits = [_a(2, 5, 5, 1), _a(2, 3, 3, 1)]
    _close(*_value_and_grads(lambda *a: jgan.gan_loss(list(a), False),
                             lambda *a: gan.gan_loss(list(a), False), logits))


def test_feature_matching_loss():
    fake, real = _pred(), _pred()
    n = sum(len(s) for s in fake)
    flat = [a for s in fake for a in s] + [a for s in real for a in s]
    _close(*_value_and_grads(
        lambda *a: jmatch.feature_matching_loss(_unflat(a[:n], fake),
                                                _unflat(a[n:], real), 10.0),
        lambda *a: matching.feature_matching_loss(_unflat(a[:n], fake),
                                                  _unflat(a[n:], real), 10.0),
        flat))


def _flows():
    return [_a(2, 2 * 2 ** i, 2 * 2 ** i, 2) for i in range(5)]


@pytest.mark.parametrize("mode,lasttvonly,add_lasttv", [
    ("no_edge", False, False), ("no_edge", True, False),
    ("last_only", False, True), ("weighted", False, False),
    ("weighted", False, True)])
def test_flow_tv_suite(mode, lasttvonly, add_lasttv):
    flows = _flows()
    mask = _rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    _close(*_value_and_grads(
        lambda *a: jtv.flow_tv_suite(list(a[:5]), a[5], mode, lasttvonly,
                                     add_lasttv),
        lambda *a: tv.flow_tv_suite(list(a[:5]), a[5], mode, lasttvonly,
                                    add_lasttv),
        flows + [mask]))


def test_tv_and_edge_aware_tv():
    f, m = _a(2, 16, 12, 2), _rng.uniform(0, 1, (2, 64, 48, 1)).astype(np.float32)
    _close(*_value_and_grads(jtv.tv_loss, tv.tv_loss, [f]))
    _close(*_value_and_grads(jtv.edge_aware_tv_loss, tv.edge_aware_tv_loss,
                             [f, m]))


@pytest.mark.parametrize("size", [(16, 12), (8, 6)])
def test_cross_entropy2d(size):
    """Also with a target of another size (the logits resized, align
    corners) and ignored pixels."""
    logits = _a(2, *size, 13)
    target = _rng.integers(0, 13, (2, 16, 12)).astype(np.int32)
    target[0, :3] = 250
    jv, jg = jax.value_and_grad(lambda l: jseg.cross_entropy2d(
        l, jnp.asarray(target)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    v = seg.cross_entropy2d(lt, torch.from_numpy(target))
    (g,) = torch.autograd.grad(v, lt)
    _close((v, [g]), (jv, [jg]))


def test_iou_and_miou():
    y = _rng.uniform(0, 1, (3, 8, 6, 13)).astype(np.float32)
    t = (_rng.uniform(0, 1, (3, 8, 6, 13)) > 0.7).astype(np.float32)
    np.testing.assert_allclose(
        float(seg.iou_metric(torch.from_numpy(y), torch.from_numpy(t))),
        float(jseg.iou_metric(jnp.asarray(y), jnp.asarray(t))), rtol=1e-6)
    np.testing.assert_allclose(
        float(seg.cal_miou(torch.from_numpy(y), torch.from_numpy(t))),
        float(jseg.cal_miou(jnp.asarray(y), jnp.asarray(t))), rtol=1e-6)


@pytest.fixture(scope="module")
def vgg_pair():
    jv = random_variables(JVgg(), jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)), seed=3)
    tvgg = Vgg19Features(device="cpu")
    load_jax_variables(tvgg, jv)
    tvgg.requires_grad_(False)
    return jv, tvgg


@pytest.mark.parametrize("layids", [None, (2, 4)])
def test_vgg_perceptual_loss(vgg_pair, layids):
    jv, tvgg = vgg_pair
    x, y = np.tanh(_a(2, 32, 24, 3)), np.tanh(_a(2, 32, 24, 3))
    jval, jg = jax.jit(jax.value_and_grad(lambda a: jperc.vgg_perceptual_loss(
        jv, a, jnp.asarray(y), layids)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    val = perceptual.vgg_perceptual_loss(tvgg, xt, torch.from_numpy(y), layids)
    (g,) = torch.autograd.grad(val, xt)
    _close((val, [g]), (jval, [jg]))
    # the target's tower given as features: the same number
    feats = perceptual.vgg_features(tvgg, torch.from_numpy(y))
    again = perceptual.vgg_perceptual_loss(tvgg, torch.from_numpy(x),
                                           y_feats=feats, layids=layids)
    assert float(again) == float(val)
    fn = perceptual.VGGLossFn(tvgg, layids)
    assert float(fn(torch.from_numpy(x), torch.from_numpy(y))) == float(val)


def test_make_vgg_loss_frozen_and_seeded():
    a = perceptual.make_vgg_loss(seed=1, device="cpu")
    b = perceptual.make_vgg_loss(seed=1, device="cpu")
    assert not any(p.requires_grad for p in a.vgg.parameters())
    assert all(torch.equal(p, q) for p, q in zip(a.vgg.parameters(),
                                                  b.vgg.parameters()))


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("b1,b2,schedule", [(0.5, 0.999, None),
                                            (0.0, 0.9, (3, 1000, 0))])
def test_adam_and_schedule_match_optax(b1, b2, schedule):
    """Updates 1, 2, 1000 and 1001 on shared gradients; with the schedule
    (keep 3, decay 1000) the multiplier steps at update 1000."""
    lr = 1e-3
    sched_j = joptim.lambda_decay_schedule(*schedule) if schedule else None
    sched_t = optim.lambda_decay_schedule(*schedule) if schedule else None
    tx = joptim.adam(lr, b1, b2, schedule=sched_j)
    p0 = _a(5, 4)
    jp = jnp.asarray(p0)
    st = tx.init(jp)

    @jax.jit
    def update(g, st, jp):
        upd, st = tx.update(g, st, jp)
        return optax.apply_updates(jp, upd), st

    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.adam([tp], lr, b1, b2, schedule=sched_t)
    rng = np.random.default_rng(5)
    for t in range(1, 1002):
        g = rng.standard_normal(p0.shape).astype(np.float32) * 0.1
        jp, st = update(jnp.asarray(g), st, jp)
        tp.grad = torch.from_numpy(g)
        opt.step()
        if t in (1, 2, 1000, 1001):
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                       rtol=1e-6, atol=1e-6)
    assert opt.count == 1001
    if schedule:
        assert sched_t(999) == float(sched_j(999)) == 1.0
        assert abs(sched_t(1000) - float(sched_j(1000))) < 1e-7
        assert sched_t(1000) < 1.0


# ------------------------------------------------------------------ utils

def test_legacy_helpers_match_jax():
    from hrviton_tpu.utils import legacy as jleg
    from hrviton_tpu_torch.utils import legacy
    labels = _rng.integers(0, 13, (2, 6, 5))
    np.testing.assert_array_equal(legacy.get_clothes_mask(labels).numpy(),
                                  np.asarray(jleg.get_clothes_mask(labels)))
    np.testing.assert_array_equal(legacy.changearm(labels).numpy(),
                                  np.asarray(jleg.changearm(labels)))
    np.testing.assert_array_equal(legacy.gen_noise((3, 4), 2).numpy(),
                                  np.asarray(jleg.gen_noise((3, 4), 2)))
    seg = _a(2, 6, 5, 13)
    np.testing.assert_array_equal(legacy.ndim_tensor2im(seg, 1),
                                  jleg.ndim_tensor2im(jnp.asarray(seg), 1))
    np.testing.assert_array_equal(legacy.pred_to_onehot(seg).numpy(),
                                  np.asarray(jleg.pred_to_onehot(jnp.asarray(seg))))

