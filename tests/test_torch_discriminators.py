"""The condition discriminator and the rejection math: the port against the
JAX package on the CPU, f32.

Random variables (tests/test_torch_support.py: kernels N(0, 1/fan_in),
BatchNorm running statistics, spectral u/v) go to the JAX model and,
through ``load_jax_variables``, to the port. Inputs are numpy draws from a
seed. Tolerance f32 1e-5 relative to max|ref| (with 1e-6 absolute): five
4x4 convs of up to 512 channels, each summing its products in another order
on the two sides. The pool and the rejection arithmetic are the same
elementwise f32 operations on both sides: bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.config import CondDiscriminatorConfig as JDConfig
from hrviton_tpu.infer import rejection as jrej
from hrviton_tpu.models import CondMultiscaleDiscriminator as JCondD
from hrviton_tpu.ops.pool import avg_pool2d_nopad as javg
from hrviton_tpu.train import checkpoint as jckpt
from hrviton_tpu_torch.config import CondDiscriminatorConfig
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.infer import rejection as trej
from hrviton_tpu_torch.models.discriminators import CondMultiscaleDiscriminator
from hrviton_tpu_torch.ops.pool import avg_pool2d_nopad
from hrviton_tpu_torch.train import checkpoint as tckpt
from test_torch_support import random_variables

torch.set_num_threads(1)
_REL = 1e-5


def _close(got, want, rel=_REL):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * float(np.abs(want).max()) + 1e-6
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("shape", [(2, 64, 64, 33), (1, 37, 45, 5),
                                   (1, 8, 6, 3)])
def test_avg_pool2d_nopad_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = avg_pool2d_nopad(torch.from_numpy(x))
    want = np.asarray(javg(jnp.asarray(x)))
    assert np.array_equal(got.numpy(), want)


_CONFIGS = {
    "instance": dict(),
    "spectral_ddownx2": dict(spectral=True, ddownx2=True),
    "batch_dropout_interm": dict(norm="batch", ddropout=True,
                                 get_interm_feat=True, use_sigmoid=True,
                                 num_d=3),
}


@functools.lru_cache(maxsize=None)
def _jax_d(kind):
    cfg = JDConfig(input_nc=33, **_CONFIGS[kind])
    m = JCondD(cfg)
    v = random_variables(m, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 33)),
                         train=False)
    return m, v


def _port_d(kind, v):
    d = CondMultiscaleDiscriminator(
        CondDiscriminatorConfig(input_nc=33, **_CONFIGS[kind]),
        device="cpu").eval()
    load_jax_variables(d, v)
    return d


@pytest.mark.parametrize("kind", sorted(_CONFIGS))
def test_cond_discriminator_matches_jax(kind):
    m, v = _jax_d(kind)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 33)).astype(
        np.float32)
    want = jax.jit(lambda v_, a: m.apply(v_, a, train=False))(v, x)
    with torch.no_grad():
        got = _port_d(kind, v)(torch.from_numpy(x))
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            _close(g, w)
    _close(trej.d_logit(got), jrej.d_logit(want))


def test_rejection_math_matches_jax():
    rng = np.random.default_rng(2)
    real = [rng.uniform(-0.9, 0.45, (8,)).astype(np.float32) for _ in range(3)]
    fake = [rng.uniform(-0.9, 0.45, (5,)).astype(np.float32) for _ in range(2)]
    m = trej.norm_const_from_logits(real, fake)
    assert m == jrej.norm_const_from_logits(real, fake)
    assert m == trej.norm_const_from_logits([torch.from_numpy(a) for a in real],
                                            fake)
    got = trej.rejection_scores(torch.from_numpy(real[0]), m)
    want = jrej.rejection_scores(real[0], m)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(trej.odds(real[1]), np.asarray(jrej.odds(real[1])))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _d_state_dict(v, num_d=2, n_layers=3):
    """The reference's D_*.pth keys (layer{d}.{seq index}.weight / bias),
    built by inverting the converter's mapping over JAX variables."""
    seq = [0, 2, 5, 8, 11]
    sd = {}
    for d in range(num_d):
        node = v["params"][f"discriminator_{d}"]
        for j, si in enumerate(seq):
            conv = node[f"layer{j}_conv"]["conv"]
            sd[f"layer{d}.{si}.weight"] = np.ascontiguousarray(
                conv["kernel"].transpose(3, 2, 0, 1))
            sd[f"layer{d}.{si}.bias"] = conv["bias"]
    return sd


def test_convert_cond_discriminator_matches_jax():
    m, v = _jax_d("instance")
    sd = _d_state_dict(v)
    tree = tckpt.convert_cond_discriminator(sd)
    want = jckpt.convert_cond_discriminator(sd)
    got_l, want_l, src = _leaves(tree), _leaves(want), _leaves(v)
    assert got_l.keys() == want_l.keys() == src.keys()
    for k in want_l:
        assert np.array_equal(got_l[k], want_l[k]), k
        assert np.array_equal(got_l[k], src[k]), k


# ------------------------------------------------------- SPADE discriminator

from hrviton_tpu.config import SPADEDiscriminatorConfig as JSpadeDConfig  # noqa: E402
from hrviton_tpu.models import SPADEMultiscaleDiscriminator as JSpadeD  # noqa: E402
from hrviton_tpu_torch.config import SPADEDiscriminatorConfig  # noqa: E402
from hrviton_tpu_torch.convert import export_jax_variables  # noqa: E402
from hrviton_tpu_torch.models.discriminators import \
    SPADEMultiscaleDiscriminator  # noqa: E402


@pytest.mark.parametrize("update_sn", [False, True])
@pytest.mark.parametrize("no_feat", [False, True])
def test_spade_discriminator_matches_jax(update_sn, no_feat):
    """Forward, without and with the power iteration (u/v after it
    compared too), and the input gradient."""
    cfg = dict(ndf=8, no_gan_feat_loss=no_feat)
    m = JSpadeD(JSpadeDConfig(**cfg))
    v = random_variables(m, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 10)),
                         train=False)
    x = np.random.default_rng(3).standard_normal((2, 32, 24, 10)).astype(
        np.float32)

    def f(a):
        out = m.apply(v, a, update_sn=update_sn,
                      mutable=["aux"] if update_sn else False)
        out, new = out if update_sn else (out, None)
        return sum(jnp.sum(jnp.sin(s[-1])) for s in out), (out, new)

    (_, (want, new)), gx = jax.jit(jax.value_and_grad(f, has_aux=True))(x)
    port = SPADEMultiscaleDiscriminator(SPADEDiscriminatorConfig(**cfg),
                                        device="cpu")
    load_jax_variables(port, v)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt, update_sn=update_sn)
    assert len(got) == len(want) == 2
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == (1 if no_feat else 4)
        for g, w in zip(gs, ws):
            _close(g, w)
    sum(torch.sin(s[-1]).sum() for s in got).backward()
    _close(xt.grad, gx)
    lin = [n for n, _ in port.named_parameters() if "layer1_conv" in n]
    assert lin == ["discriminator_0.layer1_conv.weight",
                   "discriminator_1.layer1_conv.weight"]   # bias-free
    from hrviton_tpu_torch.nn.layers import commit_state
    commit_state(port)
    aux = export_jax_variables(port)["aux"]
    ref = new["aux"] if update_sn else v["aux"]
    for d in ref:
        for layer in ref[d]:
            for k in ("u", "v"):
                _close(torch.from_numpy(aux[d][layer][k]), ref[d][layer][k])


def test_convert_spade_discriminator_reference_keys():
    """A D.pth under SPADE's keys (model{n}.0[.0] Sequentials, spectral
    weight_orig / weight_u / weight_v) gives the port's variables back."""
    port = SPADEMultiscaleDiscriminator(SPADEDiscriminatorConfig(ndf=8),
                                        device="cpu")
    from hrviton_tpu_torch.nn.layers import init_weights
    init_weights(port, torch.Generator().manual_seed(4))
    sd = {}
    for i in range(2):
        sub = getattr(port, f"discriminator_{i}")
        p = f"discriminator_{i}"
        sd[f"{p}.model0.0.weight"] = sub.layer0_conv.weight
        sd[f"{p}.model0.0.bias"] = sub.layer0_conv.bias
        for n in (1, 2):
            conv = getattr(sub, f"layer{n}_conv")
            sd[f"{p}.model{n}.0.0.weight_orig"] = conv.weight
            sd[f"{p}.model{n}.0.0.weight_u"] = conv.u
            sd[f"{p}.model{n}.0.0.weight_v"] = conv.v
        sd[f"{p}.model3.0.weight"] = sub.layer3_conv.weight
        sd[f"{p}.model3.0.bias"] = sub.layer3_conv.bias
    sd = {k: t.detach().numpy() for k, t in sd.items()}
    tree = tckpt.convert_spade_discriminator(sd)
    again = SPADEMultiscaleDiscriminator(SPADEDiscriminatorConfig(ndf=8),
                                         device="cpu")
    load_jax_variables(again, tree)
    for (n, a), (_, b) in zip(port.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n
