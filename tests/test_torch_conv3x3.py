"""The 3x3 conv op: the port's conv3x3 / conv3x3_wide / conv3x3_small (plain
versions on the CPU) vs the JAX package's two Pallas kernels in interpret
mode, f32, same numpy inputs; and the port's gates vs the JAX gates over the
generator's conv sites at 1024x768. The CUDA kernels themselves are held
against their plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerance 1e-4 absolute and relative: a conv sums up to 9*128 f32 products,
in different orders on the two sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu_torch.config import SPADEGenConfig
from hrviton_tpu_torch.models.spade import SPADEGenerator
from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.ops import spade_fused as tsf

c3 = importlib.import_module("hrviton_tpu.ops.conv3x3")
sf = importlib.import_module("hrviton_tpu.ops.spade_fused")
torch.set_num_threads(1)
_rng = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _interpret_small_tiles(monkeypatch):
    monkeypatch.setattr(c3, "_INTERPRET", True)
    monkeypatch.setattr(c3, "_TH", 4)
    monkeypatch.setattr(c3, "_VTH", 4)
    monkeypatch.setattr(c3, "_VIEWS", True)


def _arr(shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


def _port(fn, x, w, b, pre_act):
    """Run a port function on numpy NHWC x / HWIO w; no kernel may launch."""
    before = (tc3.conv3x3_wide.launches, tc3.conv3x3_small.launches)
    got = fn(torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1),
             None if b is None else torch.from_numpy(b), pre_act)
    assert (tc3.conv3x3_wide.launches, tc3.conv3x3_small.launches) == before
    return got.numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
def test_wide_matches_pallas(pre_act, bias):
    x, w = _arr((2, 16, 24, 128)), _arr((3, 3, 128, 12), 0.05)
    b = _arr((12,)) if bias else None
    with c3.fast_conv(True):
        assert c3.conv3x3_eligible(x.shape, w.shape, (1, 1), (1, 1), x.dtype)
        want = c3._conv3x3_pallas(jnp.asarray(x), jnp.asarray(w),
                                  None if b is None else jnp.asarray(b), pre_act)
    _close(_port(tc3.conv3x3_wide, x, w, b, pre_act), want)
    _close(_port(tc3.conv3x3, x, w, b, pre_act), want)


@pytest.mark.parametrize("cin,cout", [(9, 16), (32, 3), (32, 32)])
@pytest.mark.parametrize("pre_act", [None, "leaky0.2"])
def test_small_matches_pallas_views(cin, cout, pre_act):
    """Odd channel counts, as conv_6/conv_7 (9 -> 16) and conv_img (32 -> 3)."""
    x, w, b = _arr((2, 12, 128, cin)), _arr((3, 3, cin, cout), 0.05), _arr((cout,), 0.1)
    assert c3._views_eligible(x.shape, w.shape, (1, 1), (1, 1), x.dtype)
    want = c3._conv3x3_views_pallas(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), pre_act)
    _close(_port(tc3.conv3x3_small, x, w, b, pre_act), want)
    _close(_port(tc3.conv3x3, x, w, b, pre_act), want)


@pytest.mark.parametrize("kernel", ["wide", "small"])
def test_edge_rows_zero_padded(kernel):
    """A constant input exposes wrong halo handling at the borders."""
    x = np.ones((1, 24, 128, 8), np.float32)
    w = _arr((3, 3, 8, 4), 0.3)
    if kernel == "wide":
        with c3.fast_conv(True):
            want = c3._conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), None, None)
        got = _port(tc3.conv3x3_wide, x, w, None, None)
    else:
        want = c3._conv3x3_views_pallas(jnp.asarray(x), jnp.asarray(w), None, None)
        got = _port(tc3.conv3x3_small, x, w, None, None)
    _close(got, want)
    assert not np.allclose(got[0, 0], got[0, 12])      # the border differs


def test_ref_rounding_chains_bf16():
    """The two plain versions differ in bf16 only in where the bias joins:
    the wide chain adds it to the f32 sum and rounds once, the small chain
    rounds and then adds it in bf16. In f32 they are the same."""
    x = torch.from_numpy(_arr((1, 8, 8, 16))).bfloat16()
    w = torch.from_numpy(_arr((8, 16, 3, 3), 0.1))
    b = torch.from_numpy(_arr((8,), 3.0))
    acc = torch.nn.functional.conv2d(
        x.float().permute(0, 3, 1, 2), w.bfloat16().float(), None, 1, 1
    ).permute(0, 2, 3, 1)
    bb = b.bfloat16()
    torch.testing.assert_close(tc3.conv3x3_ref(x, w, b, fused_bias=True),
                               (acc + bb.float()).bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(tc3.conv3x3_ref(x, w, b),
                               acc.bfloat16() + bb, atol=0, rtol=0)
    xf = x.float()
    torch.testing.assert_close(tc3.conv3x3_ref(xf, w, b, fused_bias=True),
                               tc3.conv3x3_ref(xf, w, b), atol=0, rtol=0)


def test_switches_and_cpu_gates():
    x_shape, w_shape = (1, 128, 96, 128), (64, 128, 3, 3)
    small = ((1, 512, 128, 9), (16, 9, 3, 3))
    args = ((1, 1), (1, 1), torch.bfloat16)
    assert not tc3.fast_conv_enabled()
    assert not tc3.conv3x3_eligible(x_shape, w_shape, *args, "cuda")
    assert not tc3._views_eligible(*small, *args, "cuda")       # _VIEWS off
    with tc3.fast_conv(True):
        assert tc3.fast_conv_enabled()
        assert tc3.conv3x3_eligible(x_shape, w_shape, *args, "cuda")
        assert tc3.kernel_for(x_shape, w_shape, *args, "cuda") is tc3.conv3x3_wide
        assert not tc3.conv3x3_eligible(x_shape, w_shape, *args, "cpu")
        assert tc3.kernel_for(x_shape, w_shape, *args, "cpu") is None
        assert not tc3.conv3x3_eligible(x_shape, w_shape, (1, 1), (1, 1),
                                        torch.float16, "cuda")
        assert not tc3.conv3x3_eligible(x_shape, w_shape, (2, 2), (1, 1),
                                        torch.bfloat16, "cuda")
        with pytest.raises(RuntimeError):      # restored on an exception too
            with tc3.fast_conv(False):
                raise RuntimeError
        assert tc3.fast_conv_enabled()
    assert not tc3.fast_conv_enabled()
    tc3.enable_fast_conv(True)
    assert tc3.fast_conv_enabled()
    tc3.enable_fast_conv(False)


def _sites(gen, fine_hw):
    """Every 3x3 conv and every norm of a generator with its NHWC input
    shape at ``fine_hw``: (name, kind, x_shape, module)."""
    n_blocks = len(gen.block_names)
    out = []
    for i, name in enumerate(gen.block_names):
        h, w = (s // 2 ** (n_blocks - 1 - i) for s in fine_hw)
        out.append((f"conv_{i}", "conv", (4, h, w, 9), getattr(gen, f"conv_{i}")))
        blk = getattr(gen, name)
        for sub, mod in blk.named_children():
            cin = (mod.weight.shape[1] if not sub.startswith("norm")
                   else mod.noise_scale.shape[0])
            kind = "norm" if sub.startswith("norm") else "conv"
            out.append((f"{name}.{sub}", kind, (4, h, w, cin), mod))
    out.append(("conv_img", "conv", (4, *fine_hw, gen.conv_img.weight.shape[1]),
                gen.conv_img))
    return out


def _dispatch(sites, mod_gate, conv_gates):
    """Walk the generator's dispatch (models/spade.py) over the sites with
    the given gates: {site: 'modulate' | 'wide' | 'small'}."""
    small, wide = conv_gates
    routed = {}

    def conv(name, x_shape, m):
        if tuple(m.weight.shape[-2:]) != (3, 3):
            return
        if small(x_shape, m.weight.shape):
            routed[name] = "small"
        elif wide(x_shape, m.weight.shape):
            routed[name] = "wide"

    for name, kind, x_shape, m in sites:
        if kind == "conv":
            conv(name, x_shape, m)
            continue
        seg_shape = x_shape[:3] + (7,)
        conv(f"{name}.conv_shared", seg_shape, m.conv_shared)
        if mod_gate(x_shape):
            routed[name] = "modulate"
        else:
            actv_shape = x_shape[:3] + (128,)
            conv(f"{name}.conv_gamma", actv_shape, m.conv_gamma)
            conv(f"{name}.conv_beta", actv_shape, m.conv_beta)
    return routed


def test_gates_admit_the_counted_sites_at_1024x768(monkeypatch):
    """With fast_spade, fast_conv and the small-channel switch on, the port's
    gates on a CUDA device in bf16 admit, per request of the ngf=64 'most'
    generator at 1024x768: 9 norms (up_2, up_3, up_4), 8 wide convs (up_1's
    six gamma/beta convs and conv_1, up_2's conv_1) and 4 small convs (conv_6,
    conv_7, up_4.conv_1, conv_img); the JAX gates, asked as on a TPU, admit
    the same sites; and nothing is admitted on the CPU."""
    gen = SPADEGenerator(SPADEGenConfig(ngf=64), device="meta")
    sites = _sites(gen, (1024, 768))
    monkeypatch.setattr(tc3, "_VIEWS", True)
    bf = torch.bfloat16

    def port(device):
        with tc3.fast_conv(True), tsf.fast_spade(True):
            return _dispatch(
                sites,
                lambda xs: tsf.fused_spade_eligible(xs, 128, bf, device),
                (lambda xs, ws: tc3._views_eligible(xs, ws, (1, 1), (1, 1), bf, device),
                 lambda xs, ws: tc3.conv3x3_eligible(xs, ws, (1, 1), (1, 1), bf, device)))

    routed = port("cuda")
    norms = [f"{b}.{n}" for b in ("up_2", "up_3", "up_4")
             for n in ("norm_s", "norm_0", "norm_1")]
    wide = [f"up_1.{n}.{c}" for n in ("norm_s", "norm_0", "norm_1")
            for c in ("conv_gamma", "conv_beta")] + ["up_1.conv_1", "up_2.conv_1"]
    small = ["conv_6", "conv_7", "up_4.conv_1", "conv_img"]
    assert sorted(k for k, v in routed.items() if v == "modulate") == sorted(norms)
    assert sorted(k for k, v in routed.items() if v == "wide") == sorted(wide)
    assert sorted(k for k, v in routed.items() if v == "small") == sorted(small)
    assert port("cpu") == {}

    # the JAX gates with their hardware clauses open (HWIO weight shapes)
    monkeypatch.setattr(c3, "_INTERPRET", False)
    monkeypatch.setattr(sf, "_INTERPRET", False)
    monkeypatch.setattr(c3, "_TH", 8)
    monkeypatch.setattr(c3, "_VTH", 8)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    hwio = lambda ws: (ws[2], ws[3], ws[1], ws[0])
    jbf = jnp.bfloat16
    with c3.fast_conv(True), sf.fast_spade(True):
        want = _dispatch(
            sites, lambda xs: sf.fused_spade_eligible(xs, 128, jbf),
            (lambda xs, ws: c3._views_eligible(xs, hwio(ws), (1, 1), (1, 1), jbf),
             lambda xs, ws: c3.conv3x3_eligible(xs, hwio(ws), (1, 1), (1, 1), jbf)))
    assert routed == want


def test_cpu_tensor_takes_plain_version():
    """conv3x3 on a CPU tensor takes the plain version whatever the
    switches say, and counts no launch."""
    x, w = _arr((1, 8, 8, 4)), _arr((3, 3, 4, 4), 0.2)
    with tc3.fast_conv(True):
        got = _port(tc3.conv3x3, x, w, None, "relu")
    want = c3._conv3x3_ref(jnp.asarray(x), jnp.asarray(w), None, "relu")
    _close(got, want)
