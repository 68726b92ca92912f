"""The port's checkpoint readers and writer against the JAX package's, on
the CPU.

* ``.ckpt``: a file written by the JAX package's ``save_pytree`` reads back
  bit for bit through the port's msgpack reader (f32, int32, a numpy scalar,
  a complex number, bf16 as f32 of the same values), also with its arrays
  cut into ``__msgpack_chunked_array__`` chunks (flax's chunk size lowered
  for the test).
* ``.pth``: torch state dicts under the reference's key names, built by
  inverting the converters' mapping (HWIO -> OIHW) over JAX-initialised
  random variables, with BatchNorm's ``num_batches_tracked`` and the
  generator's legacy ``.Spade`` keys. The port's ``convert_tocg`` /
  ``convert_spade_gen`` give the JAX converters' trees bit for bit (and the
  variables they were built from); loaded with ``load_jax_variables`` they
  give the JAX models' outputs within the model tests' f32 limits (2e-4
  absolute, 1e-3 relative).
"""

import functools
import importlib

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.config import TOCGConfig as JTOCGConfig
from hrviton_tpu.models import ConditionGenerator as JCondition
from hrviton_tpu.models import SPADEGenerator as JSPADE
from hrviton_tpu.train import checkpoint as jckpt
from hrviton_tpu_torch.cli.common import load_gen_variables, load_tocg_variables
from hrviton_tpu_torch.config import SPADEGenConfig, TOCGConfig
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.models import ConditionGenerator, SPADEGenerator
from hrviton_tpu_torch.train import checkpoint as tckpt
from test_torch_support import injected_noise, random_variables

torch.set_num_threads(1)
_ATOL, _RTOL = 2e-4, 1e-3


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, complex):
        assert got == want, path
    else:
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)
        g = np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


# ------------------------------------------------------------------- .ckpt

def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "conv": {"kernel": rng.standard_normal((3, 3, 4, 5)).astype(np.float32),
                     "bias": np.linspace(-1, 1, 5, dtype=np.float32)},
            "norm": {"scale": jnp.asarray(rng.standard_normal(40), jnp.bfloat16)},
        },
        "aux": {"u": rng.standard_normal(100).astype(np.float32),
                "ids": np.arange(30, dtype=np.int32)},
        "step": np.int32(7),
        "c": 1.5 - 2.0j,
    }


@pytest.mark.parametrize("chunked", [False, True])
def test_ckpt_reads_back_bit_for_bit(tmp_path, monkeypatch, chunked):
    if chunked:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    path = str(tmp_path / "m.ckpt")
    jckpt.save_pytree(_tree(), path)
    raw = open(path, "rb").read()
    assert (b"__msgpack_chunked_array__" in raw) == chunked
    got = tckpt.load_pytree(path)
    _assert_tree_equal(got, jckpt.load_pytree(path))
    _assert_tree_equal(got, _tree())
    assert got["step"].dtype == np.int32 and got["step"] == 7
    # numpy scalars (flax's extension type 3; save_pytree writes 0-d arrays)
    with open(path, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(
            {"s": np.float32(0.25), "t": np.int64(-3)}))
    got = tckpt.load_pytree(path)
    assert type(got["s"]) is np.float32 and got["s"] == np.float32(0.25)
    assert type(got["t"]) is np.int64 and got["t"] == -3


@pytest.mark.parametrize("chunked", [False, True])
def test_save_pytree_writes_the_jax_bytes(tmp_path, monkeypatch, chunked):
    """The port's writer (cli/convert_checkpoint.py's) gives the JAX
    package's file byte for byte: keys sorted, numpy scalars as 0-d arrays,
    bf16, complex, and arrays over the chunk size in chunks (both sizes
    lowered for the test)."""
    if chunked:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(tckpt, "_MAX_CHUNK", 64)
    tree = _tree()
    tree["params"]["norm"]["scale"] = np.asarray(tree["params"]["norm"]["scale"])
    jckpt.save_pytree(tree, str(tmp_path / "j.ckpt"))
    tckpt.save_pytree(tree, str(tmp_path / "p" / "p.ckpt"))
    raw = (tmp_path / "p" / "p.ckpt").read_bytes()
    assert (b"__msgpack_chunked_array__" in raw) == chunked
    assert raw == (tmp_path / "j.ckpt").read_bytes()


def test_restore_into_semantics(tmp_path):
    path = str(tmp_path / "m.ckpt")
    jckpt.save_pytree(_tree(), path)
    subset = {"params": {"conv": {"kernel": np.zeros((3, 3, 4, 5))}}}
    got = tckpt.restore_into(subset, path)
    _assert_tree_equal(got, {"params": {"conv": {
        "kernel": _tree()["params"]["conv"]["kernel"]}}})
    _assert_tree_equal(got, jckpt.restore_into(subset, path))
    extra = {"params": {"conv": {"kernel": 0, "scale": 0}}}
    with pytest.raises(ValueError, match="scale"):
        tckpt.restore_into(extra, path)
    with pytest.raises(ValueError):
        jckpt.restore_into(extra, path)


# ------------------------------------------------- reference state dicts

def _oihw(k):
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _conv_sd(sd, tkey, node):
    sd[tkey + ".weight"] = _oihw(node["conv"]["kernel"])
    if "bias" in node["conv"]:
        sd[tkey + ".bias"] = np.asarray(node["conv"]["bias"])


def _bn_sd(sd, tkey, p, s):
    sd[tkey + ".weight"] = np.asarray(p["scale"])
    sd[tkey + ".bias"] = np.asarray(p["bias"])
    sd[tkey + ".running_mean"] = np.asarray(s["mean"])
    sd[tkey + ".running_var"] = np.asarray(s["var"])
    sd[tkey + ".num_batches_tracked"] = np.asarray(12, np.int64)


def _resblock_sd(sd, v, tprefix, fprefix, scale):
    p, s = v["params"][fprefix], v["batch_stats"][fprefix]
    _conv_sd(sd, f"{tprefix}.scale.1" if scale == "up" else f"{tprefix}.scale",
             p["scale_conv"])
    _conv_sd(sd, f"{tprefix}.block.0", p["conv1"])
    _bn_sd(sd, f"{tprefix}.block.1", p["norm1"], s["norm1"])
    _conv_sd(sd, f"{tprefix}.block.3", p["conv2"])
    _bn_sd(sd, f"{tprefix}.block.4", p["norm2"], s["norm2"])


def tocg_state_dict(v, out_layer):
    """The reference ConditionGenerator's state dict (networks.py:13-94)."""
    sd = {}
    for i in range(5):
        _resblock_sd(sd, v, f"ClothEncoder.{i}", f"ClothEncoder_{i}", "down")
        _resblock_sd(sd, v, f"PoseEncoder.{i}", f"PoseEncoder_{i}", "down")
    _resblock_sd(sd, v, "conv", "conv", "same")
    for i in range(5):
        _resblock_sd(sd, v, f"SegDecoder.{i}", f"SegDecoder_{i}", "up")
        _conv_sd(sd, f"flow_conv.{i}", v["params"][f"flow_conv_{i}"])
    for k in range(4):
        _conv_sd(sd, f"conv1.{k}", v["params"][f"conv1_{k}"])
        _conv_sd(sd, f"conv2.{k}", v["params"][f"conv2_{k}"])
        _conv_sd(sd, f"bottleneck.{k}.0", v["params"][f"bottleneck_{k}"])
    if out_layer == "relu":
        _resblock_sd(sd, v, "out_layer", "out_layer", "same")
    else:
        _resblock_sd(sd, v, "out_layer.0", "out_layer_res", "same")
        _conv_sd(sd, "out_layer.1", v["params"]["out_layer_conv"])
    return sd


def gen_state_dict(v):
    """The reference SPADEGenerator's state dict (network_generator.py:
    176-245) in the legacy form that test_generator.py:77-86 remaps: every
    SPADE norm's keys under '.Spade'."""
    p, a = v["params"], v["aux"]
    sd = {}
    for name in p:
        if name.startswith("conv_") or name == "conv_img":
            _conv_sd(sd, name, p[name])
            continue
        for c in ("conv_0", "conv_1", "conv_s"):
            if c in p[name]:
                t = f"{name}.{c}"
                sd[t + ".weight_orig"] = _oihw(p[name][c]["kernel"])
                if "bias" in p[name][c]:
                    sd[t + ".bias"] = np.asarray(p[name][c]["bias"])
                sd[t + ".weight_u"] = np.asarray(a[name][c]["u"])
                sd[t + ".weight_v"] = np.asarray(a[name][c]["v"])
        for n in ("norm_0", "norm_1", "norm_s"):
            if n in p[name]:
                t = f"{name}.{n}.Spade"
                sd[t + ".noise_scale"] = np.asarray(p[name][n]["noise_scale"])
                _conv_sd(sd, t + ".conv_shared.0", p[name][n]["conv_shared"])
                _conv_sd(sd, t + ".conv_gamma", p[name][n]["conv_gamma"])
                _conv_sd(sd, t + ".conv_beta", p[name][n]["conv_beta"])
    return sd


@functools.lru_cache(maxsize=None)
def _tocg(warp_feature, out_layer):
    m = JCondition(JTOCGConfig(ngf=8, warp_feature=warp_feature,
                               out_layer=out_layer))
    v = random_variables(m, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)),
                         jnp.zeros((1, 64, 64, 16)), train=False)
    return m, v


@functools.lru_cache(maxsize=None)
def _gen():
    m = JSPADE(JSPADEGenConfig(ngf=8, num_upsampling_layers="more",
                               fine_height=128, fine_width=64, remat=False))
    k = jax.random.PRNGKey(0)
    v = random_variables(m, {"params": k, "noise": k},
                         jnp.zeros((1, 128, 64, 9)), jnp.zeros((1, 128, 64, 7)),
                         train=False, seed=4)
    return m, v


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=_ATOL,
                               rtol=_RTOL)


def test_legacy_remap_matches_jax():
    keys = ["up_0.norm_0.Spade.noise_scale", "head_0.ace_0.weight",
            "conv_img.weight", "up_4.norm_s.Spade.conv_shared.0.bias"]
    sd = {k: np.float32(i) for i, k in enumerate(keys)}
    got = tckpt._legacy_remap(sd)
    assert got == jckpt._legacy_remap(sd)
    assert "up_0.norm_0.noise_scale" in got and "head_0.alias_0.weight" in got


@pytest.mark.parametrize("warp_feature,out_layer", [("T1", "relu"),
                                                    ("encoder", "conv")])
def test_convert_tocg_matches_jax(warp_feature, out_layer):
    m, v = _tocg(warp_feature, out_layer)
    sd = tocg_state_dict(v, out_layer)
    got = tckpt.convert_tocg(sd, out_layer=out_layer)
    _assert_tree_equal(got, jckpt.convert_tocg(sd, out_layer=out_layer))
    _assert_tree_equal(got, v)                       # the variables it came from
    port = ConditionGenerator(TOCGConfig(ngf=8, warp_feature=warp_feature,
                                         out_layer=out_layer), device="cpu")
    load_jax_variables(port, got)
    rng = np.random.default_rng(1)
    i1 = rng.standard_normal((1, 64, 64, 4)).astype(np.float32)
    i2 = rng.standard_normal((1, 64, 64, 16)).astype(np.float32)
    want = jax.jit(lambda v_, a, b: m.apply(v_, a, b, train=False))(v, i1, i2)
    with torch.no_grad():
        out = port(torch.from_numpy(i1), torch.from_numpy(i2))
    for a, b in zip(out[0], want[0]):
        _close(a, b)
    for a, b in zip(out[1:], want[1:]):
        _close(a, b)


def test_convert_spade_gen_matches_jax():
    m, v = _gen()
    sd = gen_state_dict(v)
    assert any(".Spade." in k for k in sd)
    got = tckpt.convert_spade_gen(sd, "more")
    _assert_tree_equal(got, jckpt.convert_spade_gen(sd, "more"))
    _assert_tree_equal(got, v)
    port = SPADEGenerator(SPADEGenConfig(ngf=8, num_upsampling_layers="more",
                                         fine_height=128, fine_width=64),
                          device="cpu")
    load_jax_variables(port, got)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 128, 64, 9)).astype(np.float32)
    labels = rng.integers(0, 7, (1, 128, 64)).astype(np.int32)
    with injected_noise(rng) as draws:
        want = jax.jit(lambda v_, x_, l_: m.apply(
            v_, x_, l_, train=False, rngs={"noise": jax.random.PRNGKey(0)}))(
                v, x, labels)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(labels), draws)
    assert 0.05 < np.asarray(want).std() < 0.9
    _close(out, want)


def test_cli_loaders_fill_the_modules(tmp_path):
    """A .pth (torch.save of the reference state dict) and a .ckpt
    (the JAX package's save_pytree) of the same weights load the same
    tensors into the port's modules."""
    _, tv = _tocg("T1", "relu")
    _, gv = _gen()
    tsd, gsd = tocg_state_dict(tv, "relu"), gen_state_dict(gv)
    pth = lambda name, sd: torch.save({k: torch.from_numpy(np.array(a))
                                       for k, a in sd.items()},
                                      str(tmp_path / name))
    pth("mtviton.pth", tsd)
    pth("gen.pth", gsd)
    np.testing.assert_array_equal(
        tckpt.load_torch_state_dict(str(tmp_path / "mtviton.pth"))[
            "conv.block.1.running_var"], tsd["conv.block.1.running_var"])
    jckpt.save_pytree(tv, str(tmp_path / "tocg.ckpt"))
    jckpt.save_pytree(gv, str(tmp_path / "gen.ckpt"))
    gcfg = SPADEGenConfig(ngf=8, num_upsampling_layers="more",
                          fine_height=128, fine_width=64)
    for make, load, files, extra in (
            (lambda: ConditionGenerator(TOCGConfig(ngf=8), device="cpu"),
             load_tocg_variables, ("mtviton.pth", "tocg.ckpt"), "relu"),
            (lambda: SPADEGenerator(gcfg, device="cpu"),
             load_gen_variables, ("gen.pth", "gen.ckpt"), "more")):
        a = load(str(tmp_path / files[0]), make(), extra).state_dict()
        b = load(str(tmp_path / files[1]), make(), extra).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
