"""On the card: each hand-written CUDA kernel vs its plain version.

Imports no JAX (the machine with the card has none), so it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``; here,
without a card, each test skips.

The model-path kernels run for bf16 on the card only (``_build.runs_kernel``):
an f32 call of their wrappers on the card is their plain version, bit for
bit, and launches nothing.

Tolerances: f32 with TF32 off, 1e-4 x max|ref| (f32 sums of up to 9*128
products in another order); bf16, 2 bf16 ulps of max|ref| (each plain
version rounds the same intermediates to bf16 as its kernel, and a sum in
another order flips single roundings). The band-copy probe is a copy: bit
for bit. The shift formulations of the conv experiments sum the same f32
products as their plain versions, per kx first: the same 2 ulps.
"""

import numpy as np
import pytest
import torch

from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.ops import spade_block as tsb
from hrviton_tpu_torch.ops import spade_fused as tsf
from hrviton_tpu_torch.tools import exp_conv, exp_conv2, exp_copy_probe

_ORDER = ("x", "noise", "nscale", "actv", "wg", "bg", "wb", "bb", "wc", "bc")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _a(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).cuda()


def _inputs(dtype, b, h, w, c, cout, ksize, residual, nh=128):
    rng = np.random.default_rng(0)
    a = lambda shape, scale=1.0: _a(rng, shape, scale)
    t = dict(x=a((b, h, w, c)).to(dtype), noise=a((b, h, w, 1)),
             nscale=a((c,), 0.1), actv=a((b, h, w, nh)).to(dtype),
             wg=a((c, nh, 3, 3), 0.05), bg=a((c,), 0.1),
             wb=a((c, nh, 3, 3), 0.05), bb=a((c,), 0.1),
             wc=a((cout, c, ksize, ksize), 0.05), bc=a((cout,), 0.1))
    res = a((b, h, w, cout)).to(dtype) if residual else None
    return [t[k] for k in _ORDER], res


def _shifted(x, seed=1):
    """x with channel means and scales well away from 0 and 1 (x * (1 + 2u)
    + 3v per channel), so that the statistics and the normalize step show
    in the unit's output."""
    rng = np.random.default_rng(seed)
    c = x.shape[-1]
    u = torch.from_numpy(rng.uniform(0, 1, c).astype(np.float32)).cuda()
    v = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).cuda()
    return (x.float() * (1 + 2 * u) + 3 * v).to(x.dtype)


def _knock_inputs(b, h, w, c, cout, ksize, residual):
    args, res = _inputs(torch.bfloat16, b, h, w, c, cout, ksize, residual)
    args[0] = _shifted(args[0])
    return args, res


def _tells_apart(prod, want):
    """The production unit's output fails the limit a knocked output is
    held to: the comparison can tell the variant from the production unit."""
    scale = want.float().abs().max().item()
    err = (prod.float() - want.float()).abs().max().item()
    assert err > 2 * 2 ** -7 * scale, (err, scale)


def _assert_plain(got, want, counters, before):
    """An f32 call on the card: its plain version bit for bit, and no
    launch counter moved."""
    torch.cuda.synchronize()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert [f.launches for f in counters] == before


def _assert_close(got, want, dtype):
    scale = want.float().abs().max().item()
    tol = 1e-4 * scale if dtype == torch.float32 else 2 * 2 ** -7 * scale
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= tol, (err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ksize,residual,pre_act", [
    (3, True, "leaky0.2"), (1, False, None), (3, False, "relu")])
def test_kernel_matches_plain(dtype, ksize, residual, pre_act):
    """bf16: the kernels; f32: the plain version, bit for bit, no launch.
    Ragged 37x45 exercises every edge mask of the engine's 8x32 tiling."""
    _need_card()
    args, res = _inputs(dtype, 2, 37, 45, 40, 24, ksize, residual)
    counters = (tsb.spade_conv_unit, tsf.norm_stats)
    before = [f.launches for f in counters]
    got = tsb.spade_conv_unit(pre_act, *args, res)
    want = tsb.spade_conv_ref(*args, pre_act=pre_act, residual=res)
    if dtype == torch.float32:
        _assert_plain(got, want, counters, before)
        return
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [n + 1 for n in before]
    _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("knock", tsb.KNOCK_SETS, ids="+".join)
@pytest.mark.parametrize("gb_bn", [64, 80, 96])
@pytest.mark.parametrize("ks,cout", [(3, 24), (1, 16), (3, 32)])
def test_knock_variants_match_plain(knock, gb_bn, ks, cout, monkeypatch):
    """Each knock variant of the unit's two kernels against the plain
    knocked unit (2 bf16 ulps of max|ref|), at every stage (a) tile and a
    ragged 37x45, on x whose statistics are far from mu = 0, rsig = 1; the
    production unit fails that limit (a variant that still did the knocked
    work would too); actv_dma (undefined output) for its shape; each kernel
    the call launches counts once, the variant's in its counter, an
    unknocked stage's in knock_production, the unit's counter not at all."""
    _need_card()
    monkeypatch.setattr(tsf, "_GB_BN", (gb_bn,))
    c = gb_bn // 2
    args, res = _knock_inputs(2, 37, 45, c, cout, ks, ks == 3)
    counters = {**tsb.knock_counters,
                **{f"{s}/production": n for s, n in tsb.knock_production.items()}}
    counts = {k: n.launches for k, n in counters.items()}
    before = tsb.spade_conv_unit.launches
    got = tsb.spade_conv_unit("leaky0.2", *args, res, knock=knock)
    torch.cuda.synchronize()
    assert tsb.spade_conv_unit.launches == before
    moved = {k: n.launches - counts[k] for k, n in counters.items()
             if n.launches != counts[k]}
    knocked = {f"{'conv' if t.startswith('cons') else 'gb'}/{t}"
               for t in knock if ks == 3 or not t.startswith("cons")}
    want_moved = dict.fromkeys(knocked, 1)
    for stage in ("gb", "conv"):
        if not any(k.startswith(stage) for k in knocked):
            want_moved[f"{stage}/production"] = 1
    assert moved == want_moved
    if knock == ("actv_dma",):
        assert got.shape == (2, 37, 45, cout)
        return
    want = tsb.spade_conv_ref(*args, pre_act="leaky0.2", residual=res,
                              knock=knock)
    _assert_close(got, want, torch.bfloat16)
    if knocked:          # the consumer's tags are no-ops for a 1x1 conv
        _tells_apart(tsb.spade_conv_unit("leaky0.2", *args, res), want)


@pytest.mark.gpu
def test_knock_stats_and_f32():
    """stats runs no statistics kernel and both production kernels, on x
    whose statistics are far from mu = 0, rsig = 1 (the production unit
    fails the limit); a knocked f32 call is the plain knocked unit, as on
    the CPU, bit for bit, and launches nothing; two tags of one stage in
    bf16 raise."""
    _need_card()
    from hrviton_tpu_torch.ops import spade_fused
    args, res = _knock_inputs(1, 16, 32, 32, 32, 3, True)
    before = spade_fused.norm_stats.launches, tsb.spade_conv_unit.launches
    prod0 = {s: n.launches for s, n in tsb.knock_production.items()}
    got = tsb.spade_conv_unit(None, *args, res, knock=("stats",))
    assert (spade_fused.norm_stats.launches,
            tsb.spade_conv_unit.launches) == before
    assert {s: n.launches - prod0[s]
            for s, n in tsb.knock_production.items()} == {"gb": 1, "conv": 1}
    want = tsb.spade_conv_ref(*args, residual=res, knock=("stats",))
    _assert_close(got, want, torch.bfloat16)
    _tells_apart(tsb.spade_conv_unit(None, *args, res), want)
    args32, res32 = _inputs(torch.float32, 1, 16, 32, 32, 32, 3, True)
    counters = (tsf.norm_stats, tsb.spade_conv_unit,
                *tsb.knock_counters.values(), *tsb.knock_production.values())
    before = [f.launches for f in counters]
    for knock in (("normalize",), ("stats",)):
        _assert_plain(
            tsb.spade_conv_unit(None, *args32, res32, knock=knock),
            tsb.spade_conv_ref(*args32, residual=res32, knock=knock),
            counters, before)
    with pytest.raises(NotImplementedError):   # two tags of one stage
        tsb.spade_conv_unit(None, *args, res, knock=("normalize", "modulate"))


@pytest.mark.gpu
def test_kernel_rejects_bad_input():
    _need_card()
    args, _ = _inputs(torch.float16, 1, 8, 8, 8, 8, 3, False)
    with pytest.raises(TypeError):
        tsb.spade_conv_unit(None, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 128, 272])
def test_modulate_kernel_matches_plain(dtype, c):
    """Ragged 37x45 (every edge mask of the engine's 8x32 tiling); in bf16
    c = 40 is one N tile of 40 channels, c = 128 three of 48 (the last part
    padding), c = 272 six of 48. f32: the plain version, bit for bit, no
    launch."""
    _need_card()
    args, _ = _inputs(dtype, 2, 37, 45, c, 8, 3, False)
    counters = (tsf.fused_spade_modulate, tsf.norm_stats)
    before = [f.launches for f in counters]
    got = tsf.fused_spade_modulate(*args[:8])
    if dtype == torch.float32:
        _assert_plain(got, tsf.modulate_ref(*args[:8]), counters, before)
        return
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [n + 1 for n in before]
    _assert_close(got, tsf.modulate_ref(*args[:8]), dtype)


@pytest.mark.gpu
def test_modulate_kernel_edge_rows():
    """Constant actv: a halo clamped at the image edge instead of zero-filled
    would show in the border pixels."""
    _need_card()
    args, _ = _inputs(torch.bfloat16, 1, 32, 48, 16, 8, 3, False)
    args[3] = torch.ones_like(args[3])
    got = tsf.fused_spade_modulate(*args[:8])
    _assert_close(got, tsf.modulate_ref(*args[:8]), torch.bfloat16)


def _conv_inputs(dtype, b, h, w, cin, cout, bias=True):
    rng = np.random.default_rng(1)
    x = _a(rng, (b, h, w, cin)).to(dtype)
    wt = _a(rng, (cout, cin, 3, 3), (1.0 / (9 * cin)) ** 0.5)
    return x, wt, _a(rng, (cout,), 0.3) if bias else None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,pre_act,bias", [
    (128, 528, "relu", True), (256, 72, "leaky0.2", True),
    (64, 33, None, False)])
def test_wide_conv_kernel_matches_plain(dtype, cin, cout, pre_act, bias):
    """bf16: the kernel; f32: the plain version, bit for bit, no launch."""
    _need_card()
    x, w, b = _conv_inputs(dtype, 2, 37, 45, cin, cout, bias)
    before = tc3.conv3x3_wide.launches
    got = tc3.conv3x3_wide(x, w, b, pre_act)
    want = tc3.conv3x3_ref(x, w, b, pre_act, fused_bias=True)
    if dtype == torch.float32:
        _assert_plain(got, want, (tc3.conv3x3_wide,), [before])
        return
    torch.cuda.synchronize()
    assert tc3.conv3x3_wide.launches == before + 1
    _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,pre_act,bias", [
    (9, 16, None, True), (32, 32, "leaky0.2", True), (32, 3, "leaky0.2", True),
    (7, 42, "relu", False), (20, 24, "relu", True)])
def test_small_conv_kernel_matches_plain(dtype, cin, cout, pre_act, bias):
    """Odd channel counts: a pixel of 9 or 7 channels is 18 or 14 bytes (in
    bf16 the engine's narrow input), 20 channels are read from a copy padded
    to 24, 3 output channels are one N tile of 8, 42 two of 32; ragged 37
    rows and W = 45 (partly filled 8-column tiles), but W = 40 for a narrow
    bf16 input, which needs W * Cin % 8 == 0. f32: the plain version, bit
    for bit, no launch."""
    _need_card()
    narrow = dtype == torch.bfloat16 and cin % 8 and cin < 15
    x, w, b = _conv_inputs(dtype, 2, 37, 40 if narrow else 45, cin, cout, bias)
    before = tc3.conv3x3_small.launches
    got = tc3.conv3x3_small(x, w, b, pre_act)
    want = tc3.conv3x3_ref(x, w, b, pre_act)
    if dtype == torch.float32:
        _assert_plain(got, want, (tc3.conv3x3_small,), [before])
        return
    torch.cuda.synchronize()
    assert tc3.conv3x3_small.launches == before + 1
    _assert_close(got, want, dtype)


@pytest.mark.gpu
def test_conv_kernel_edge_rows():
    """Constant input: the conv's zero padding shows in the border pixels."""
    _need_card()
    x, w, _ = _conv_inputs(torch.bfloat16, 1, 32, 48, 32, 32, False)
    x = torch.ones_like(x)
    _assert_close(tc3.conv3x3_small(x, w), tc3.conv3x3_ref(x, w), torch.bfloat16)
    _assert_close(tc3.conv3x3_wide(x, w),
                  tc3.conv3x3_ref(x, w, fused_bias=True), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["ones", "corners"])
@pytest.mark.parametrize("cin,cout,w", [(9, 16, 40), (9, 16, 72), (32, 3, 40),
                                        (13, 8, 8)])
def test_small_conv_kernel_borders(cin, cout, w, pattern):
    """Constant input and an impulse in each corner, 2 images of 16 rows: the
    zero border of a narrow input's rows (elements left of a row's first
    pixel, right of its last) and of the 4-D boxes; W = 72 puts the last
    column strip 8 pixels in, W = 8 (Cin 13: boxes of 232 elements) leaves
    one strip that is mostly border."""
    _need_card()
    x, wt, b = _conv_inputs(torch.bfloat16, 2, 16, w, cin, cout, True)
    if pattern == "ones":
        x = torch.ones_like(x)
    else:
        corners = torch.zeros_like(x)
        for r in (0, -1):
            for c in (0, -1):
                corners[:, r, c] = x[:, r, c]
        x = corners
    got = tc3.conv3x3_small(x, wt, None)
    ref = tc3.conv3x3_ref(x, wt, None)
    _assert_close(got, ref, torch.bfloat16)
    assert torch.equal(got == 0, ref == 0)          # nothing leaked across a border
    _assert_close(tc3.conv3x3_small(x, wt, b), tc3.conv3x3_ref(x, wt, b), torch.bfloat16)


@pytest.mark.gpu
def test_small_conv_weights_follow_in_place_updates():
    """Packed once per weight tensor; written in place, packed again."""
    _need_card()
    x, w, b = _conv_inputs(torch.bfloat16, 1, 16, 64, 9, 16, True)
    for _ in range(3):
        _assert_close(tc3.conv3x3_small(x, w, b), tc3.conv3x3_ref(x, w, b), torch.bfloat16)
        w.mul_(-1.5)
        b.add_(0.25)


@pytest.mark.gpu
def test_new_kernels_reject_bad_input():
    _need_card()
    x, w, b = _conv_inputs(torch.bfloat16, 1, 16, 16, 44, 48)
    with pytest.raises(ValueError):
        tc3.conv3x3_small(x, w, b)                # 3 * 44 > 128
    x9, w9, b9 = _conv_inputs(torch.bfloat16, 1, 16, 20, 9, 16)
    with pytest.raises(ValueError):
        tc3.conv3x3_small(x9, w9, b9)             # narrow: W * Cin % 8
    with pytest.raises(ValueError):
        tc3.conv3x3_wide(x, w, b)                 # bf16: Cin % 8
    with pytest.raises(ValueError):
        tc3.conv3x3(x, w, b)                      # no gate admits it
    with pytest.raises(TypeError):
        tc3.conv3x3_wide(x.half(), w, b)
    with pytest.raises(ValueError):
        tc3.conv3x3_wide(x.permute(0, 2, 1, 3), w, b)   # not contiguous
    args, _ = _inputs(torch.float16, 1, 8, 8, 8, 8, 3, False)
    with pytest.raises(TypeError):
        tsf.fused_spade_modulate(*args[:8])
    args, _ = _inputs(torch.bfloat16, 1, 8, 8, 7, 8, 3, False)
    with pytest.raises(ValueError):
        tsf.fused_spade_modulate(*args[:8])       # bf16: odd C
    args, _ = _inputs(torch.bfloat16, 1, 8, 8, 20, 8, 3, False)
    with pytest.raises(ValueError):
        tsf.fused_spade_modulate(*args[:8])       # bf16: C % 8


# The staging formulations of the conv experiments (csrc/conv_tma.cu: halo,
# and the BAND kind of band and dma, whose blocks share each stage's weights
# over a cluster) and the band-copy probe (csrc/copy_probe.cu: TMA loads
# and stores), bf16 only.
_TOOL_CONVS = {
    "band": (exp_conv.conv_band, exp_conv.conv_band_ref),
    "halo": (exp_conv2.conv_halo, exp_conv2.conv_halo_ref),
    "dma": (exp_conv2.conv_dma, exp_conv2.conv_dma_ref),
}
# (b, h, w, cin, cout, th): 11 bands (a block walks 8, the next 3) and 3
# bands, W no multiple of the 32- or 16-column strip, Cin one, three and one
# 16-channel chunks (40: the third half from the map's bounds), Cout under
# one 128-channel tile and 130 (two tiles, so two clusters per group of
# strips); one strip (W = 5), padded to a whole cluster; 3 strips at th = 8
# (W = 70), an odd count
_TOOL_SHAPES = [(2, 88, 37, 16, 24, 8), (1, 48, 45, 40, 72, 16),
                (3, 96, 20, 8, 130, 32), (1, 16, 5, 16, 16, 8),
                (2, 24, 70, 24, 40, 8)]


def _tool_inputs(b, h, w, cin, cout):
    rng = np.random.default_rng(2)
    x = _a(rng, (b, h, w, cin)).to(torch.bfloat16)
    return x, _a(rng, (3, 3, cin, cout), 0.1).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _TOOL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", sorted(_TOOL_CONVS))
def test_tool_conv_kernel_matches_plain(kind, shape):
    _need_card()
    run, plain = _TOOL_CONVS[kind]
    b, h, w, cin, cout, th = shape
    x, wt = _tool_inputs(b, h, w, cin, cout)
    before = run.launches
    got = run(x, wt, th=th)
    torch.cuda.synchronize()
    assert run.launches == before + 1
    assert tuple(got.shape) == (b, h, w, cout)
    _assert_close(got, plain(x, wt, th), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 16, 5, 16, 16, 8), (2, 24, 70, 40, 130, 8),
                                   (1, 16, 130, 8, 24, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("kind", ["band", "dma"])
def test_band_cluster_variants_match_plain(kind, cluster, shape):
    """conv_band and conv_dma in each cluster they were chosen from (th = 8):
    one strip padded to a whole cluster, 3 strips (odd) x two N tiles, 5
    strips (padded to 6 or 8)."""
    _need_card()
    from hrviton_tpu_torch.tools import _common
    run, plain = _TOOL_CONVS[kind]
    b, h, w, cin, cout, th = shape
    x, wt = _tool_inputs(b, h, w, cin, cout)
    launch, out = _common.conv_launcher(f"conv_{kind}_forward_bf16", x, wt, th,
                                        cluster=cluster)
    launch()
    torch.cuda.synchronize()
    _assert_close(out, plain(x, wt, th), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(_TOOL_CONVS))
def test_tool_conv_kernel_edge_rows(kind):
    """Constant input: the conv's zero padding shows in the border pixels."""
    _need_card()
    run, plain = _TOOL_CONVS[kind]
    x, wt = _tool_inputs(1, 32, 48, 32, 32)
    x = torch.ones_like(x)
    _assert_close(run(x, wt, th=8), plain(x, wt, 8), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (2, 88, 37, 16, 8), (1, 48, 45, 8, 16), (3, 96, 70, 24, 32),
    (1, 16, 5, 128, 16), (2, 32, 333, 128, 16), (1, 8, 300, 8, 8),
    (1, 24, 19, 264, 8), (4, 256, 160, 128, 8)],
    ids=lambda s: "x".join(map(str, s)))
def test_probe_kernel_is_bit_exact(shape):
    """Odd band counts (11), one band that is first and last at once (W = 5
    inside one segment; W = 300 at C = 8: two segments of up to 256 columns,
    the second ragged), W no multiple of the column segment (45, 70, 333 at
    segments of 10 columns at C = 128 and TH = 16), C = 8 (16-byte pixels),
    C = 264 (two channel boxes of 136, the second 8 past C), and more items
    than a block's ring of slots holds (the ring wraps)."""
    _need_card()
    b, h, w, c, th = shape
    x = _a(np.random.default_rng(3), (b, h, w, c)).to(torch.bfloat16)
    before = exp_copy_probe.probe.launches
    got = exp_copy_probe.probe(x, th=th)
    torch.cuda.synchronize()
    assert exp_copy_probe.probe.launches == before + 1
    assert torch.equal(got, x)
    assert torch.equal(exp_copy_probe.probe_ref(x, th), x)


@pytest.mark.gpu
def test_tool_kernels_reject_bad_input():
    _need_card()
    x, wt = _tool_inputs(1, 48, 16, 16, 16)
    counts = [f.launches for f, _ in _TOOL_CONVS.values()] \
        + [exp_copy_probe.probe.launches]
    for run, _ in _TOOL_CONVS.values():
        with pytest.raises(TypeError):
            run(x.float(), wt.float())                      # bf16 only
        with pytest.raises(ValueError):
            run(x, wt, th=24)                               # th: 8, 16 or 32
        with pytest.raises(ValueError):
            run(x, wt, th=32)                               # 48 % 32
        with pytest.raises(ValueError):
            run(x.permute(0, 2, 1, 3), wt, th=8)            # not contiguous
    with pytest.raises(ValueError, match="multiple of 8"):  # x as it is: C % 8
        exp_conv2.conv_halo(x[..., :12].contiguous(),
                            wt[:, :, :12].contiguous(), th=8)
    with pytest.raises(TypeError):
        exp_copy_probe.probe(x.float(), th=16)
    with pytest.raises(ValueError):
        exp_copy_probe.probe(x[..., :12].contiguous(), th=16)   # C % 8
    with pytest.raises(ValueError):
        exp_copy_probe.probe(x, th=32)
    with pytest.raises(ValueError):
        exp_copy_probe.probe(x.permute(0, 2, 1, 3), th=16)
    assert counts == [f.launches for f, _ in _TOOL_CONVS.values()] \
        + [exp_copy_probe.probe.launches]


# The shift formulations (roll, prodroll, e2, e: csrc/conv_tma.cu), bf16, th
# 8 or 16.
_SHIFT_CONVS = {
    "roll": (exp_conv2.conv_roll, exp_conv2.conv_roll_ref),
    "prodroll": (exp_conv2.conv_prodroll, exp_conv2.conv_prodroll_ref),
    "e": (exp_conv2.conv_e, exp_conv2.conv_e_ref),
    "e2": (exp_conv2.conv_e2, exp_conv2.conv_e2_ref),
}
# (b, h, w, cin, cout, th): 11 bands, Cin half a chunk, W = 37 (under one
# tile of e, one strip of prodroll and e2); 3 bands, Cin = 40 (the second
# chunk's tail is zero-filled), W = 45, Cout = 72 (two channel tiles of 64,
# the second ragged); one band that is first and last at once, W = 70 (e: a
# second tile of 6 columns), Cout = 130; W = 64 k, whose last column is the
# last of a tile of e (stored by that tile, no p2 term), at k = 2; W = 64 k +
# 1, whose last tile of e holds one column, at k = 1 and 2
_SHIFT_SHAPES = [(2, 88, 37, 16, 24, 8), (1, 48, 45, 40, 72, 16),
                 (3, 8, 70, 8, 130, 8), (2, 16, 128, 24, 72, 8),
                 (1, 32, 65, 40, 24, 16), (1, 16, 129, 16, 130, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _SHIFT_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", sorted(_SHIFT_CONVS))
def test_shift_conv_kernel_matches_plain(kind, shape):
    _need_card()
    run, plain = _SHIFT_CONVS[kind]
    b, h, w, cin, cout, th = shape
    x, wt = _tool_inputs(b, h, w, cin, cout)
    before = run.launches
    got = run(x, wt, th=th)
    torch.cuda.synchronize()
    assert run.launches == before + 1
    assert tuple(got.shape) == (b, h, w, cout)
    _assert_close(got, plain(x, wt, th), torch.bfloat16)


# the kernels whose borders are the kernel's own work: the shift formulations
# and conv_halo, conv_band and conv_dma, whose zero border is the
# out-of-bounds fill of their TMA boxes
_BORDER_CONVS = {**_SHIFT_CONVS, **_TOOL_CONVS}


@pytest.mark.gpu
@pytest.mark.parametrize("th", [8, 16])
@pytest.mark.parametrize("pattern", ["ones", "corners"])
@pytest.mark.parametrize("kind", sorted(_BORDER_CONVS))
def test_shift_conv_kernel_borders(kind, pattern, th):
    """Two bands (a first and a last) and 64 columns (the image's first and
    last column in blocks of their own kind). Constant input: the conv's zero
    padding shows in the border rows and columns. An impulse in each corner:
    a shift that wrapped, a border column not masked, a window read through a
    wrong swizzle or a box filled with anything but zeros outside the image
    would put a corner's taps where they do not belong."""
    _need_card()
    run, plain = _BORDER_CONVS[kind]
    x, wt = _tool_inputs(1, 2 * th, 64, 32, 32)
    if pattern == "ones":
        x = torch.ones_like(x)
    else:
        corners = torch.zeros_like(x)
        for r in (0, -1):
            for c in (0, -1):
                corners[:, r, c] = x[:, r, c]
        x = corners
    got = run(x, wt, th=th)
    ref = plain(x, wt, th)
    _assert_close(got, ref, torch.bfloat16)
    assert torch.equal(got == 0, ref == 0)          # nothing leaked across a border


@pytest.mark.gpu
def test_shift_kernels_reject_bad_input():
    _need_card()
    x, wt = _tool_inputs(1, 48, 16, 16, 16)
    counts = [f.launches for f, _ in _SHIFT_CONVS.values()]
    for kind, (run, _) in _SHIFT_CONVS.items():
        with pytest.raises(TypeError):
            run(x.float(), wt.float())                      # bf16 only
        with pytest.raises(ValueError):
            run(x, wt, th=24)                               # th: 8 or 16
        with pytest.raises(ValueError):
            run(torch.cat([x, x], 1), wt, th=32)            # built for 8 and 16
        with pytest.raises(ValueError):
            run(x, wt, th=32)                               # 48 % 32
        with pytest.raises(ValueError):
            run(x.permute(0, 2, 1, 3), wt, th=8)            # not contiguous
        with pytest.raises(ValueError, match="multiple of 8"):  # x as it is: C % 8
            run(x[..., :12].contiguous(), wt[:, :, :12].contiguous(), th=8)
    assert counts == [f.launches for f, _ in _SHIFT_CONVS.values()]


# The seven kernels of csrc/conv_tma.cu: x by TMA boxes, products on wgmma.
_TMA_CONVS = {**_TOOL_CONVS, **_SHIFT_CONVS}
# (b, h, w, cin, cout, th). A block owns 32 / 16 / 8 columns at th 8 / 16 / 32
# and 128 output channels, a stage 16 input channels. W below one block, one
# band (H == th), Cin = 8 (half a chunk, from the map's bounds), Cout = 130
# (two channel tiles, the second almost empty); W = 45 ragged at every block
# width, Cin = 40 (the third chunk half from the bounds); 3 bands, W = 37,
# Cin = 128 (eight chunks: the ring of stages wraps twice per band); 9 bands
# (a block walks 8, the next 1), W = 33 (one column into the second block)
_TMA_SHAPES = [(1, 8, 5, 8, 130, 8), (2, 16, 45, 40, 24, 16),
               (1, 24, 37, 128, 16, 8), (2, 72, 33, 16, 130, 8),
               (1, 16, 5, 40, 130, 16)]
_TMA_CASES = [(k, s) for k in sorted(_TMA_CONVS) for s in _TMA_SHAPES] \
    + [("halo", (2, 32, 45, 40, 130, 32)), ("halo", (1, 64, 7, 8, 24, 32))]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", _TMA_CASES,
                         ids=[f"{k}-" + "x".join(map(str, s))
                              for k, s in _TMA_CASES])
def test_tma_conv_kernel_matches_plain(kind, shape):
    _need_card()
    run, plain = _TMA_CONVS[kind]
    b, h, w, cin, cout, th = shape
    x, wt = _tool_inputs(b, h, w, cin, cout)
    before = run.launches
    got = run(x, wt, th=th)
    torch.cuda.synchronize()
    assert run.launches == before + 1
    assert tuple(got.shape) == (b, h, w, cout)
    _assert_close(got, plain(x, wt, th), torch.bfloat16)


# The product-shift kernels of csrc/conv_tma.cu (prodroll, e2, e): 64 output
# channels a block, 32 input channels a stage; prodroll and e2 walk 64 rows
# of one strip of 62 output columns (64 product columns), two at a time, e
# a run of the batch's row pairs, each row in tiles of 64 columns. (b, h, w,
# cin, cout, th): 11 bands at th 8, W = 40 below one strip or tile, Cin = 16
# (one stage, its second chunk zero), Cout = 24 (under one N tile); one band
# at th 16, W = 130 (two strips and 6 columns of a third; e: two tiles and 2
# columns of a third), Cin = 136 (CINP = 160: too many chunks to stay in
# shared memory, the weights come with every stage), Cout = 72 (the second N
# tile ragged); Cin = 72 (three stages, the last half from the map's bounds
# and half zero; the weights stay), Cout = 130; the tools' width (13 strips,
# 12 tiles); W one strip exactly, Cin = Cout = 8.
_PRODUCT_SHIFT_SHAPES = [(2, 88, 40, 16, 24, 8), (1, 16, 130, 136, 72, 16),
                         (2, 16, 70, 72, 130, 8), (1, 24, 768, 128, 128, 8),
                         (3, 32, 62, 8, 8, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _PRODUCT_SHIFT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["prodroll", "e2", "e"])
def test_product_shift_tma_kernel_matches_plain(kind, shape):
    _need_card()
    run, plain = _SHIFT_CONVS[kind]
    b, h, w, cin, cout, th = shape
    x, wt = _tool_inputs(b, h, w, cin, cout)
    before = run.launches
    got = run(x, wt, th=th)
    torch.cuda.synchronize()
    assert run.launches == before + 1
    assert tuple(got.shape) == (b, h, w, cout)
    _assert_close(got, plain(x, wt, th), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(_TMA_CONVS))
def test_tma_conv_kernel_follows_its_tensors(kind):
    """Two calls on tensors at other addresses and of another shape: a tensor
    map kept from the first call would read the first call's x or weights."""
    _need_card()
    run, plain = _TMA_CONVS[kind]
    x1, w1 = _tool_inputs(1, 16, 40, 16, 24)
    keep = torch.empty(1 << 20, device="cuda")      # moves the next allocations
    x2, w2 = _tool_inputs(2, 32, 24, 32, 40)
    x3, w3 = torch.flip(x1, (2,)).contiguous(), (w1 * 0.5).contiguous()
    assert len({t.data_ptr() for t in (x1, x2, x3)}) == 3
    for x, wt in ((x1, w1), (x2, w2), (x3, w3), (x1, w1)):
        _assert_close(run(x, wt, th=8), plain(x, wt, 8), torch.bfloat16)
    del keep


# The TMA / wgmma conv engine (csrc/conv_engine.cuh): the wide conv, the
# unit's two stages at every N tile they are built for, and the one-pass
# statistics (csrc/spade_fused.cu).
@pytest.mark.gpu
@pytest.mark.parametrize("bn", [32, 64, 96, 128, 136])
def test_wide_conv_engine_every_tile(bn, monkeypatch):
    """Ragged 37x45 and 150 output channels at each N tile (several tiles,
    the last one part padding), relu as the transform on A."""
    _need_card()
    monkeypatch.setattr(tc3, "_WIDE_BN", (bn,))
    x, w, b = _conv_inputs(torch.bfloat16, 2, 37, 45, 128, 150, True)
    assert tc3.wide_bn(x.shape, 150) == bn
    _assert_close(tc3.conv3x3_wide(x, w, b, "relu"),
                  tc3.conv3x3_ref(x, w, b, "relu", fused_bias=True), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("gb_bn", [64, 80, 96])
@pytest.mark.parametrize("ks,cout", [(3, 24), (1, 64), (3, 72)])
def test_unit_stages_every_tile(gb_bn, ks, cout, monkeypatch):
    """The unit with C = N / 2 of stage (a)'s tile and a consumer tile of 32,
    64 or 128 columns, ragged 37x45, leaky, residual on the 3x3 ones."""
    _need_card()
    monkeypatch.setattr(tsf, "_GB_BN", (gb_bn,))
    c = gb_bn // 2
    args, res = _inputs(torch.bfloat16, 2, 37, 45, c, cout, ks, ks == 3)
    assert tsb.gb_tiles(c) == (c, 1)
    got = tsb.spade_conv_unit("leaky0.2", *args, res)
    _assert_close(got, tsb.spade_conv_ref(*args, pre_act="leaky0.2", residual=res),
                  torch.bfloat16)


@pytest.mark.gpu
def test_unit_split_gamma_beta_tiles():
    """C = 144 is three N tiles of 48 channels; the epilogues of the second
    and third start at channels 48 and 96."""
    _need_card()
    args, res = _inputs(torch.bfloat16, 1, 24, 40, 144, 64, 3, True)
    assert tsb.gb_tiles(144)[1] > 1
    _assert_close(tsb.spade_conv_unit(None, *args, res),
                  tsb.spade_conv_ref(*args, residual=res), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("gb_bn", [64, 80, 96])
def test_modulate_every_tile(gb_bn, monkeypatch):
    """The modulation at C = 72 in N tiles of 32, 40 or 48 channels (three,
    two, two: the last part padding), ragged 37x45."""
    _need_card()
    monkeypatch.setattr(tsf, "_GB_BN", (gb_bn,))
    args, _ = _inputs(torch.bfloat16, 2, 37, 45, 72, 8, 3, False)
    assert tsf.gb_tiles(72)[0] == gb_bn // 2
    _assert_close(tsf.fused_spade_modulate(*args[:8]), tsf.modulate_ref(*args[:8]),
                  torch.bfloat16)


@pytest.mark.gpu
def test_modulate_weights_follow_in_place_updates():
    _need_card()
    args, _ = _inputs(torch.bfloat16, 1, 16, 32, 32, 8, 3, False)
    for _ in range(3):
        _assert_close(tsf.fused_spade_modulate(*args[:8]), tsf.modulate_ref(*args[:8]),
                      torch.bfloat16)
        args[6].mul_(-1.5)                   # beta's weights
        args[5].add_(0.25)                   # gamma's bias


@pytest.mark.gpu
def test_unit_weights_follow_in_place_updates():
    """The packed weights are kept between calls: a weight written in place
    must be packed again."""
    _need_card()
    args, _ = _inputs(torch.bfloat16, 1, 16, 32, 32, 32, 3, False)
    for step in range(3):
        _assert_close(tsb.spade_conv_unit("relu", *args),
                      tsb.spade_conv_ref(*args, pre_act="relu"), torch.bfloat16)
        args[4].mul_(-1.5)                   # gamma's weights
        args[8].add_(0.01)                   # the consumer's
        args[9].mul_(2.0)                    # its bias


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 37, 45, 40), (1, 9, 11, 13), (2, 64, 48, 144)])
def test_norm_stats_matches_instance_stats(dtype, shape):
    """bf16: the kernel, mu within 1e-4 of the channel's std, rsig within
    1e-4 relative; C = 13 takes the unvectorised loads. f32: the plain
    version, bit for bit, no launch."""
    _need_card()
    rng = np.random.default_rng(4)
    b, h, w, c = shape
    x = (_a(rng, shape) * 2 + 3).to(dtype)
    noise, nscale = _a(rng, (b, h, w, 1)), _a(rng, (c,), 0.1)
    before = tsf.norm_stats.launches
    mu, rsig = tsf.norm_stats(x, noise, nscale)
    mu0, rsig0 = tsf.instance_stats(x, noise, nscale)
    if dtype == torch.float32:
        _assert_plain((mu, rsig), (mu0, rsig0), (tsf.norm_stats,), [before])
        return
    torch.cuda.synchronize()
    assert tsf.norm_stats.launches == before + 1
    assert ((mu - mu0).abs() * rsig0).max().item() <= 1e-4
    assert ((rsig - rsig0).abs() / rsig0).max().item() <= 1e-4


@pytest.mark.gpu
def test_engine_kernels_reject_bad_input():
    _need_card()
    args, _ = _inputs(torch.bfloat16, 1, 8, 8, 20, 8, 3, False)
    with pytest.raises(ValueError):
        tsb.spade_conv_unit(None, *args)     # bf16: C % 8
    args, _ = _inputs(torch.bfloat16, 1, 8, 8, 16, 12, 3, False)
    with pytest.raises(ValueError):
        tsb.spade_conv_unit(None, *args)     # bf16: COUT % 8
    x = torch.zeros(1, 8, 8, 4, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        tsf.norm_stats(x, torch.zeros(1, 8, 8, 1, device="cuda"),
                       torch.zeros(4, device="cuda"))


@pytest.mark.gpu
def test_f32_pipeline_is_free_of_tf32(monkeypatch):
    """An f32 TryOnPipeline gives the same rgb under torch's default TF32
    settings (cuDNN's on) as with TF32 off, within the f32 limit 1e-4 x
    max|ref|: every library conv and matmul of its forward runs with TF32
    off and the caller's settings come back. Prints what a forward with
    TF32 on (the guard taken out) gives, for comparison."""
    _need_card()
    import contextlib
    from hrviton_tpu_torch.core import precision
    from hrviton_tpu_torch import (PipelineConfig, SPADEGenConfig, TOCGConfig,
                                   TryOnPipeline)
    from hrviton_tpu_torch.pipelines.tryon import tryon_forward
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    pipe = TryOnPipeline(
        PipelineConfig(fine_height=256, fine_width=128, cond_height=64,
                       cond_width=64),
        TOCGConfig(ngf=16), SPADEGenConfig(ngf=16, fine_height=256,
                                           fine_width=128), seed=3)
    rng = np.random.default_rng(5)
    batch = {"cloth": _a(rng, (1, 256, 128, 3)),
             "cloth_mask": _a(rng, (1, 256, 128, 1)).sigmoid(),
             "parse_agnostic": _a(rng, (1, 256, 128, 13)),
             "densepose": _a(rng, (1, 256, 128, 3)),
             "agnostic": _a(rng, (1, 256, 128, 3))}
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, False     # torch's defaults
        default, _ = pipe(batch)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, False)
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        off, _ = pipe(batch)
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        monkeypatch.setattr(precision, "no_tf32", contextlib.nullcontext)
        noise = torch.Generator(device="cuda").manual_seed(pipe.noise_seed)
        with torch.inference_mode():
            on, _ = tryon_forward(pipe.tocg,
                                  lambda x, s: pipe.generator(x, s, noise),
                                  batch, pipe.cfg)
    finally:
        monkeypatch.undo()
        cudnn.allow_tf32 = matmul.allow_tf32 = False
    print(f"TF32 on against off: max_abs "
          f"{(on - off).abs().max().item():.3e}")
    _assert_close(default, off, torch.float32)


@pytest.mark.gpu
def test_discriminator_is_free_of_tf32(monkeypatch):
    """The condition discriminator called directly in f32 (33 channels at
    256x192, spectral norm on, so its sigma's matmul runs too) gives the
    same logits under torch's default TF32 settings as with TF32 off, within
    1e-4 x max|ref|, and leaves the caller's settings as they were. Prints
    what a forward with TF32 on (the guard taken out) gives."""
    _need_card()
    import contextlib
    from hrviton_tpu_torch.config import CondDiscriminatorConfig
    from hrviton_tpu_torch.core import precision
    from hrviton_tpu_torch.models.discriminators import \
        CondMultiscaleDiscriminator
    from hrviton_tpu_torch.nn.layers import init_weights
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    d = CondMultiscaleDiscriminator(CondDiscriminatorConfig(spectral=True))
    init_weights(d, torch.Generator().manual_seed(0))
    x = _a(np.random.default_rng(6), (2, 256, 192, 33))
    run = lambda: torch.cat([s[-1].flatten() for s in d(x)])
    try:
        with torch.inference_mode():
            cudnn.allow_tf32, matmul.allow_tf32 = True, False   # torch's defaults
            default = run()
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, False)
            cudnn.allow_tf32 = matmul.allow_tf32 = False
            off = run()
            cudnn.allow_tf32 = matmul.allow_tf32 = True
            monkeypatch.setattr(precision, "no_tf32", contextlib.nullcontext)
            on = run()
    finally:
        monkeypatch.undo()
        cudnn.allow_tf32 = matmul.allow_tf32 = False
    print(f"discriminator, TF32 on against off: max_abs "
          f"{(on - off).abs().max().item():.3e}")
    _assert_close(default, off, torch.float32)
    # the same through the replayed rejection step (test_condition's
    # condition_step: a graph recorded under each setting)
    from hrviton_tpu_torch.cli import test_condition as tc
    from hrviton_tpu_torch.config import TOCGConfig
    from hrviton_tpu_torch.models.condition import ConditionGenerator
    tocg = ConditionGenerator(TOCGConfig(ngf=8)).eval()
    init_weights(tocg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(9)
    x1, x2 = _a(rng, (2, 256, 192, 4)), _a(rng, (2, 256, 192, 16))
    logits = {}
    try:
        for tf32 in (True, False):
            cudnn.allow_tf32, matmul.allow_tf32 = tf32, False
            caps = tc._condition_step.captures
            tc.condition_step(tocg, d, x1, x2)
            logits[tf32] = tc.condition_step(tocg, d, x1, x2)[-1]
            assert tc._condition_step.captures == caps + 1
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (tf32, False)
    finally:
        cudnn.allow_tf32 = matmul.allow_tf32 = False
    _assert_close(logits[True], logits[False], torch.float32)


@pytest.mark.gpu
def test_f32_pipeline_launches_no_kernel():
    """The gates take bf16 only, as the JAX gates do: an f32 TryOnPipeline
    at a size whose up_3 and up_4 pass the unit's shape rules (fine
    512x256) launches no hand-written kernel; the same pipeline in bf16
    launches the fused unit 6 times (and its statistics 6)."""
    _need_card()
    from hrviton_tpu_torch import (PipelineConfig, SPADEGenConfig, TOCGConfig,
                                   TryOnPipeline)
    from hrviton_tpu_torch.core.precision import bf16_params
    wrappers = (tsb.spade_conv_unit, tsf.norm_stats, tsf.fused_spade_modulate,
                tc3.conv3x3_wide, tc3.conv3x3_small)
    pipe = TryOnPipeline(
        PipelineConfig(fine_height=512, fine_width=256, cond_height=128,
                       cond_width=64),
        TOCGConfig(ngf=16), SPADEGenConfig(ngf=16, fine_height=512,
                                           fine_width=256), seed=3)
    rng = np.random.default_rng(7)
    batch = {"cloth": _a(rng, (1, 512, 256, 3)),
             "cloth_mask": _a(rng, (1, 512, 256, 1)).sigmoid(),
             "parse_agnostic": _a(rng, (1, 512, 256, 13)),
             "densepose": _a(rng, (1, 512, 256, 3)),
             "agnostic": _a(rng, (1, 512, 256, 3))}
    counts = lambda: [w.launches for w in wrappers]
    before = counts()
    rgb, _ = pipe(batch)
    torch.cuda.synchronize()
    assert counts() == before and torch.isfinite(rgb).all()
    bf16_params(pipe.tocg)
    bf16_params(pipe.generator)
    pipe.dtype = torch.bfloat16
    pipe(batch)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [6, 6, 0, 0, 0]


def _grads(fn, args, g):
    leaves = [None if a is None else a.detach().clone().requires_grad_(True)
              for a in args]
    out = fn(*leaves)
    idx = [i for i, a in enumerate(leaves) if a is not None]
    return out, torch.autograd.grad(out, [leaves[i] for i in idx], g)


@pytest.mark.gpu
@pytest.mark.parametrize("residual", [False, True])
def test_unit_function_grads_are_the_plain_autograd(residual):
    """The fused unit's autograd.Function on the card: its backward is the
    plain version's autograd on the saved inputs (2 bf16 ulps)."""
    _need_card()
    args, res = _inputs(torch.bfloat16, 2, 256, 128, 40, 24, 3, residual)
    args = args + [res]
    g = torch.randn(2, 256, 128, 24, device="cuda").bfloat16()
    before = tsb.spade_conv_unit.launches
    out, gk = _grads(lambda *a: tsb.spade_conv_unit("leaky0.2", *a), args, g)
    assert tsb.spade_conv_unit.launches == before + 1
    ref, gp = _grads(lambda *a: tsb.spade_conv_ref(
        *a[:10], pre_act="leaky0.2", residual=a[10]), args, g)
    _assert_close(out, ref.detach(), torch.bfloat16)
    for a, b in zip(gk, gp):
        _assert_close(a, b, torch.bfloat16)


@pytest.mark.gpu
def test_wide_kernel_reads_weights_after_an_optimizer_step():
    """The engine's weight-pack cache: after an in-place optimizer update
    the kernel packs and reads the new weights."""
    _need_card()
    rng = np.random.default_rng(1)
    x = _a(rng, (2, 128, 96, 128)).bfloat16()
    w = torch.nn.Parameter(_a(rng, (64, 128, 3, 3), 0.02).bfloat16())
    opt = torch.optim.SGD([w], lr=10.0)
    tc3.conv3x3_wide(x, w, None, "relu").float().square().mean().backward()
    before = tc3.conv3x3_wide(x, w.detach(), None, "relu")
    opt.step()
    after = tc3.conv3x3_wide(x, w.detach(), None, "relu")
    assert not torch.equal(before, after)
    _assert_close(after, tc3.conv3x3_ref(x, w.detach(), None, "relu",
                                         fused_bias=True), torch.bfloat16)


@pytest.mark.gpu
def test_nccl_rank_step_equals_the_step_without_a_group():
    """core/mesh.py over NCCL: one rank (the card) joins a group through
    init_distributed; its ConditionTrainer step (tocg ngf=8 at 64x64,
    batch 2, f32) gives the losses of the same step without a group within
    1e-5 relative, and the group is torn down after it."""
    _need_card()
    import socket
    from hrviton_tpu_torch.config import (CondDiscriminatorConfig,
                                          ConditionTrainConfig, TOCGConfig)
    from hrviton_tpu_torch.core import mesh as mesh_lib
    from hrviton_tpu_torch.models.backbones import Vgg19Features
    from hrviton_tpu_torch.nn.layers import init_weights
    from hrviton_tpu_torch.train.condition_trainer import ConditionTrainer

    rng = np.random.default_rng(2)
    a = lambda *s: _a(rng, s)
    labels = torch.from_numpy(rng.integers(0, 13, (2, 64, 64))).cuda()
    parse = torch.nn.functional.one_hot(labels, 13).float()
    batch = {"cloth": {"paired": a(2, 64, 64, 3)},
             "cloth_mask": {"paired": a(2, 64, 64, 1).sigmoid()},
             "parse_agnostic": a(2, 64, 64, 13), "densepose": a(2, 64, 64, 3),
             "parse_onehot": labels, "parse": parse,
             "pcm": parse[..., 3:4].clone(), "parse_cloth": a(2, 64, 64, 3)}
    vgg = Vgg19Features(device="cuda")
    init_weights(vgg, torch.Generator().manual_seed(7))

    def step(mesh):
        trainer = ConditionTrainer(TOCGConfig(ngf=8),
                                   CondDiscriminatorConfig(ndf=8, ddropout=True),
                                   ConditionTrainConfig(), device=mesh.device,
                                   mesh=mesh)
        return trainer.train_step(trainer.init(0), batch, vgg)[1]

    plain = step(mesh_lib.make_mesh("cuda"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = mesh_lib.init_distributed(f"127.0.0.1:{port}", 1, 0, "cuda")
    try:
        mesh = mesh_lib.make_mesh(dev)
        assert mesh.group is not None and mesh.world_size == 1
        grouped = step(mesh)
    finally:
        mesh_lib.shutdown_distributed()
    assert not torch.distributed.is_initialized()
    for k, v in plain.items():
        assert torch.isfinite(v)
        assert abs(float(grouped[k]) - float(v)) <= 1e-5 * abs(float(v)) + 1e-7, k


@pytest.mark.gpu
@pytest.mark.parametrize("train", [False, True])
def test_aliasbatch_generator_launches_no_kernel(train):
    """'spectralaliasbatch' in bf16 with the fused unit on (fine 512x256,
    where up_3 and up_4 pass the unit's shape rules): no hand-written kernel
    launches, as the JAX gates refuse the alias kinds; the output is finite
    and, in training mode, the running statistics move."""
    _need_card()
    from hrviton_tpu_torch.config import SPADEGenConfig
    from hrviton_tpu_torch.models.spade import SPADEGenerator
    from hrviton_tpu_torch.nn.layers import commit_state, init_weights
    wrappers = (tsb.spade_conv_unit, tsf.norm_stats, tsf.fused_spade_modulate,
                tc3.conv3x3_wide, tc3.conv3x3_small)
    gen = SPADEGenerator(SPADEGenConfig(ngf=16, fine_height=512, fine_width=256,
                                        fused_block=True,
                                        norm_g="spectralaliasbatch"),
                         device="cuda", dtype=torch.bfloat16)
    init_weights(gen, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    x = _a(rng, (2, 512, 256, 9)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, 7, (2, 512, 256))).cuda()
    counts = lambda: [w.launches for w in wrappers]
    before = counts()
    mean0 = gen.up_4.norm_1.param_free_norm.running_mean.clone()
    with torch.no_grad():
        rgb = gen(x, labels, torch.Generator(device="cuda").manual_seed(1),
                  train=train)
    commit_state(gen)
    torch.cuda.synchronize()
    assert counts() == before
    assert torch.isfinite(rgb).all()
    moved = not torch.equal(gen.up_4.norm_1.param_free_norm.running_mean, mean0)
    assert moved == train


def _captured_pipeline(batch_size=1, seed=3):
    """A bf16 TryOnPipeline at fine 512x256 (up_3 and up_4 pass the unit's
    shape rules), tocg and SPADE ngf=16, non-zero noise scales, and a batch
    made with numpy from ``seed``."""
    from hrviton_tpu_torch import (PipelineConfig, SPADEGenConfig, TOCGConfig,
                                   TryOnPipeline)
    from hrviton_tpu_torch.core.precision import bf16_params
    pipe = TryOnPipeline(
        PipelineConfig(fine_height=512, fine_width=256, cond_height=128,
                       cond_width=64),
        TOCGConfig(ngf=16), SPADEGenConfig(ngf=16, fine_height=512,
                                           fine_width=256), seed=3)
    bf16_params(pipe.tocg)
    bf16_params(pipe.generator)
    pipe.dtype = torch.bfloat16
    with torch.no_grad():
        for name, p in pipe.generator.named_parameters():
            if name.endswith("noise_scale"):
                p.fill_(0.2)
    return pipe, _pipeline_batch(batch_size, seed)


def _pipeline_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"cloth": _a(rng, (n, 512, 256, 3)),
            "cloth_mask": _a(rng, (n, 512, 256, 1)).sigmoid(),
            "parse_agnostic": _a(rng, (n, 512, 256, 13)),
            "densepose": _a(rng, (n, 512, 256, 3)),
            "agnostic": _a(rng, (n, 512, 256, 3))}


def _equal_outputs(got, want):
    """Every tensor of two (rgb, ConditionOutputs) pairs bit for bit."""
    rgb, cond = got
    rgb0, cond0 = want
    assert torch.equal(rgb, rgb0)
    for name in cond._fields:
        a, b = getattr(cond, name), getattr(cond0, name)
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y), name


@pytest.mark.gpu
def test_pipeline_replay_equals_eager():
    """TryOnPipeline replays a CUDA graph recorded at its first call: the
    replay gives eager's outputs (graphs.disabled()) bit for bit and counts
    the fused unit's launches as eager does (6 and 6 statistics)."""
    _need_card()
    from hrviton_tpu_torch.core import graphs
    from hrviton_tpu_torch.pipelines import tryon
    pipe, batch = _captured_pipeline()
    with graphs.disabled():
        pipe(batch)
        before = tsb.spade_conv_unit.launches, tsf.norm_stats.launches
        want = pipe(batch)
        eager = (tsb.spade_conv_unit.launches - before[0],
                 tsf.norm_stats.launches - before[1])
    caps = tryon._forward.captures
    pipe(batch)
    assert tryon._forward.captures == caps + 1
    before = tsb.spade_conv_unit.launches, tsf.norm_stats.launches
    got = pipe(batch)
    torch.cuda.synchronize()
    assert tryon._forward.captures == caps + 1
    assert eager == (6, 6)
    assert (tsb.spade_conv_unit.launches - before[0],
            tsf.norm_stats.launches - before[1]) == eager
    _equal_outputs(got, want)


@pytest.mark.gpu
def test_pipeline_replay_outputs_are_not_overwritten():
    """Call k's outputs are fresh tensors: call k+1 on another batch leaves
    them as they were."""
    _need_card()
    pipe, batch = _captured_pipeline()
    pipe(batch)
    rgb, cond = pipe(batch)
    saved = rgb.clone(), cond.warped_cloth.clone()
    other, _ = pipe(_pipeline_batch(1, 4))
    torch.cuda.synchronize()
    assert not torch.equal(other, rgb)
    assert torch.equal(rgb, saved[0]) and torch.equal(cond.warped_cloth, saved[1])


@pytest.mark.gpu
def test_pipeline_replay_sees_weights_loaded_after_capture():
    """Weights loaded in place after a replay (load_jax_variables) are
    used: the signature is recorded anew and gives eager's result with the
    new weights."""
    _need_card()
    from hrviton_tpu_torch.convert import (export_jax_variables,
                                           load_jax_variables)
    from hrviton_tpu_torch.core import graphs
    from hrviton_tpu_torch.pipelines import tryon
    pipe, batch = _captured_pipeline()
    pipe(batch)
    old, _ = pipe(batch)
    other, _ = _captured_pipeline(seed=3)
    from hrviton_tpu_torch.nn.layers import init_weights
    init_weights(other.generator, torch.Generator().manual_seed(11))
    caps = tryon._forward.captures
    load_jax_variables(pipe.generator, export_jax_variables(other.generator))
    got = pipe(batch)
    assert tryon._forward.captures == caps + 1
    with graphs.disabled():
        want = pipe(batch)
    _equal_outputs(got, want)
    assert not torch.equal(got[0], old)


@pytest.mark.gpu
def test_pipeline_recaptures_for_a_new_batch_size():
    """A new batch size records a graph of its own (as jit compiles anew);
    each size then replays its own."""
    _need_card()
    from hrviton_tpu_torch.core import graphs
    from hrviton_tpu_torch.pipelines import tryon
    pipe, batch = _captured_pipeline()
    two = _pipeline_batch(2, 5)
    caps = tryon._forward.captures
    pipe(batch)
    pipe(two)
    assert tryon._forward.captures == caps + 2
    got1, got2 = pipe(batch), pipe(two)
    assert tryon._forward.captures == caps + 2
    with graphs.disabled():
        _equal_outputs(got1, pipe(batch))
        _equal_outputs(got2, pipe(two))


@pytest.mark.gpu
def test_entry_point_calling_item_raises_on_the_card(monkeypatch):
    """An entry point that syncs the host (``.item()``) cannot be recorded:
    the call raises on the card instead of running eagerly, and the next
    entry point records and replays as before."""
    _need_card()
    from hrviton_tpu_torch.cli import test_condition as tc
    from hrviton_tpu_torch.config import CondDiscriminatorConfig, TOCGConfig
    from hrviton_tpu_torch.models.condition import ConditionGenerator
    from hrviton_tpu_torch.models.discriminators import \
        CondMultiscaleDiscriminator
    from hrviton_tpu_torch.nn.layers import init_weights
    from hrviton_tpu_torch.pipelines import tryon as tt
    tocg = ConditionGenerator(TOCGConfig(ngf=8)).eval()
    d = CondMultiscaleDiscriminator(CondDiscriminatorConfig(ndf=8)).eval()
    init_weights(tocg, torch.Generator().manual_seed(0))
    init_weights(d, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(8)
    x1, x2 = _a(rng, (2, 64, 64, 4)), _a(rng, (2, 64, 64, 16))
    plain = tt.compose_clothmask

    def syncing(seg, wcm, mode):
        float(seg.sum().item())
        return plain(seg, wcm, mode)
    monkeypatch.setattr(tc, "compose_clothmask", syncing)
    caps = tc._condition_step.captures
    with pytest.raises(RuntimeError):
        tc.condition_step(tocg, d, x1, x2)
    assert tc._condition_step.captures == caps
    monkeypatch.setattr(tc, "compose_clothmask", plain)
    got = tc.condition_step(tocg, d, x1, x2)
    got = tc.condition_step(tocg, d, x1, x2)
    from hrviton_tpu_torch.core import graphs
    with graphs.disabled():
        want = tc.condition_step(tocg, d, x1, x2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


class _TimedGraph:
    """A recorded graph whose replays are bracketed by CUDA events."""

    def __init__(self, graph):
        self.graph, self.times = graph, []

    def replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        self.times.append((a, b))


@pytest.mark.gpu
def test_device_spans_sum_to_the_replay():
    """With tracing on, the try-on graph holds the three device spans; over
    five replays of a bf16 forward their sum is within 2% of CUDA events
    recorded around the replays, and each span is harvested under its
    launch."""
    _need_card()
    from hrviton_tpu_torch.pipelines import tryon
    from hrviton_tpu_torch.utils import profiling
    pipe, batch = _captured_pipeline(batch_size=4)
    profiling.clear()
    profiling.enable()
    try:
        pipe(batch)
        entry = tryon._forward.last_entry
        assert [n for n, _, _ in entry.marks.pairs] == [
            "tryon.tocg", "tryon.lift", "tryon.generator"]
        timed = entry.graph = _TimedGraph(entry.graph)
        for _ in range(5):
            pipe(batch)
        profiling.flush()
        records = profiling.spans()
    finally:
        profiling.disable()
        profiling.clear()
    launches = [s.id for s in records if s.name == "graphs.launch"][-5:]
    device = [s for s in records if s.device and s.parent in launches]
    assert len(device) == 15 and all(s.t1_ns > s.t0_ns for s in device)
    spans_ms = sum(s.t1_ns - s.t0_ns for s in device) / 1e6
    outer_ms = sum(a.elapsed_time(b) for a, b in timed.times)
    assert abs(spans_ms - outer_ms) <= 0.02 * outer_ms, (spans_ms, outer_ms)


def _node_kinds(graph, path):
    """{node type: count} of a recorded graph, from its DOT dump."""
    import collections
    import re
    graph.debug_dump(str(path))
    return collections.Counter(re.findall(
        r"\b(KERNEL|MEMSET|MEMCPY|EVENT_RECORD|WAIT_EVENT)\b", path.read_text()))


@pytest.mark.gpu
def test_traced_graph_adds_only_its_event_nodes(tmp_path):
    """With tracing off the try-on graph has no event node, and it is the
    graph recorded with tracing on less that graph's six event nodes (two a
    device span): off, the tracer leaves the recorded graph as it was."""
    _need_card()
    from hrviton_tpu_torch.pipelines import tryon
    from hrviton_tpu_torch.utils import profiling
    pipe, batch = _captured_pipeline()
    assert not profiling.enabled()
    pipe(batch)
    off = _node_kinds(tryon._forward.last_entry.graph, tmp_path / "off.dot")
    profiling.enable()
    try:
        pipe(batch)
        on = _node_kinds(tryon._forward.last_entry.graph, tmp_path / "on.dot")
    finally:
        profiling.disable()
        profiling.clear()
    assert off["KERNEL"] > 0 and off["EVENT_RECORD"] == 0, off
    assert on - off == {"EVENT_RECORD": 6} and not off - on, (on, off)


# ------------------------------------------ the loader's batch to the card

_BUSY_CYCLES = 10 ** 9      # torch.cuda._sleep: about half a second


def _loader_batch(n=2, h=256, w=192, seed=0):
    """A compact loader batch as the CLI hands it to ``to_device``: uint8
    arrays nested one level, a float32 array, and the name lists."""
    rng = np.random.default_rng(seed)
    u8 = lambda c: rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    idx = lambda: rng.integers(0, 13, (n, h, w), dtype=np.uint8)
    names = [f"{i:05d}_00.jpg" for i in range(n)]
    return {"cloth": {"paired": u8(3), "unpaired": u8(3)},
            "cloth_mask": {"paired": u8(1) & 1, "unpaired": u8(1) & 1},
            "parse_idx": idx(), "parse_agnostic_idx": idx(), "image": u8(3),
            "densepose": u8(3), "pose": u8(3), "agnostic": u8(3),
            "pcm": rng.standard_normal((n, h, w, 1)).astype(np.float32),
            "im_name": names, "c_name": {"paired": names, "unpaired": names}}


def _arrays(batch, prefix=""):
    """(key path, numpy array) of each array of a loader batch."""
    for k, v in batch.items():
        if isinstance(v, dict):
            yield from _arrays(v, f"{prefix}{k}/")
        elif isinstance(v, np.ndarray):
            yield f"{prefix}{k}", v


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.gpu
def test_to_device_equals_the_pageable_copy():
    """The pinned path gives the tensors of ``torch.from_numpy(v).to(device)``
    bit for bit, dtypes, shapes and nesting included; the name lists pass
    through as the same objects."""
    _need_card()
    from hrviton_tpu_torch.data.device import to_device
    raw = _loader_batch()
    got = to_device(raw, "cuda")
    torch.cuda.synchronize()
    assert set(got) == set(raw)
    assert got["im_name"] is raw["im_name"]
    assert got["c_name"] == raw["c_name"]
    assert all(got["c_name"][k] is raw["c_name"][k] for k in raw["c_name"])
    for path, v in _arrays(raw):
        t, want = _leaf(got, path), torch.from_numpy(v).to("cuda")
        assert t.device.type == "cuda" and t.dtype == want.dtype, path
        assert t.shape == want.shape and torch.equal(t, want), path


@pytest.mark.gpu
def test_to_device_copies_survive_overwritten_arrays():
    """The numpy arrays overwritten as soon as ``to_device`` returns, while
    its copies still wait behind a busy stream: the device tensors hold the
    values the arrays had (the host staged them before returning)."""
    _need_card()
    from hrviton_tpu_torch.data.device import to_device
    raw = _loader_batch(seed=1)
    want = {path: v.copy() for path, v in _arrays(raw)}
    torch.cuda.synchronize()
    busy = torch.cuda.Event()
    torch.cuda._sleep(_BUSY_CYCLES)
    busy.record()
    got = to_device(raw, "cuda")
    for _, v in _arrays(raw):
        v += 1
    queued = not busy.query()
    torch.cuda.synchronize()
    assert queued, "the stream drained before the arrays were overwritten"
    for path, v in want.items():
        assert torch.equal(_leaf(got, path).cpu(), torch.from_numpy(v)), path


@pytest.mark.gpu
def test_to_device_returns_before_a_busy_stream_drains():
    """With the current stream held busy, ``to_device`` returns before the
    busy kernel ends, and kernels queued after it on that stream read the
    copied values."""
    _need_card()
    from hrviton_tpu_torch.data.device import to_device
    raw = _loader_batch(seed=2)
    torch.cuda.synchronize()
    busy = torch.cuda.Event()
    torch.cuda._sleep(_BUSY_CYCLES)
    busy.record()
    got = to_device(raw, "cuda")
    returned_first = not busy.query()
    after = {path: _leaf(got, path) * 1 for path, _ in _arrays(raw)}
    torch.cuda.synchronize()
    assert returned_first, "to_device waited for the stream"
    for path, v in _arrays(raw):
        assert torch.equal(after[path].cpu(), torch.from_numpy(v)), path


@pytest.mark.gpu
def test_to_device_reuses_its_pinned_memory():
    """Once a call's copies have ended, later calls of the same batch
    page-lock nothing new: the caching host allocator hands the same blocks
    out again (its count of blocks created stays put)."""
    _need_card()
    from hrviton_tpu_torch.data.device import to_device
    raw = _loader_batch(seed=3)
    to_device(raw, "cuda")
    torch.cuda.synchronize()
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(4):
        to_device(raw, "cuda")
        torch.cuda.synchronize()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before


# ------------------------------------------ the training steps, recorded

def _train_state(stage, seed=0, schedule=None):
    """A training state on the card at a small size, as a dict: ``step(batch)
    -> metrics``, ``tensors()`` (every tensor a step writes), ``gens``,
    ``counts()``, ``batches``, the trainer and its state. Stage 1: the tocg
    ngf=8 at 64x64, f32, the condition discriminator ndf 8 with --Ddropout.
    Stage 2: SPADE ngf=16 'most' at 512x256 (up_3 and up_4 pass the unit's
    shape rules), bf16, the fused unit on, remat, non-zero noise scales, the
    SPADE discriminator ndf 8, the frozen tocg ngf=8 at 128x64, one noise
    generator for both forwards."""
    from hrviton_tpu_torch.config import (CondDiscriminatorConfig,
                                          ConditionTrainConfig,
                                          GeneratorTrainConfig, PipelineConfig,
                                          SPADEDiscriminatorConfig,
                                          SPADEGenConfig, TOCGConfig)
    from hrviton_tpu_torch.models.backbones import Vgg19Features
    from hrviton_tpu_torch.models.condition import ConditionGenerator
    from hrviton_tpu_torch.nn.layers import init_weights
    from hrviton_tpu_torch.train import condition_trainer as ct
    from hrviton_tpu_torch.train import generator_trainer as gt
    vgg = Vgg19Features(device="cuda")
    init_weights(vgg, torch.Generator().manual_seed(7))
    vgg.requires_grad_(False)
    rng = np.random.default_rng(seed + 40)
    if stage == "condition":
        trainer = ct.ConditionTrainer(
            TOCGConfig(ngf=8), CondDiscriminatorConfig(input_nc=33, ndf=8,
                                                       ddropout=True),
            ConditionTrainConfig(), device="cuda")
        state = trainer.init(seed)
        gens = [trainer.dropout]
        step = lambda b: trainer.train_step(state, b, vgg)[1]
        batches = []
        for _ in range(3):
            labels = torch.from_numpy(rng.integers(0, 13, (2, 64, 64))).cuda()
            parse = torch.nn.functional.one_hot(labels, 13).float()
            a = lambda *s: _a(rng, s)
            batches.append({"cloth": {"paired": a(2, 64, 64, 3)},
                            "cloth_mask": {"paired": a(2, 64, 64, 1).sigmoid()},
                            "parse_agnostic": a(2, 64, 64, 13),
                            "densepose": a(2, 64, 64, 3),
                            "parse_onehot": labels.int(), "parse": parse,
                            "pcm": parse[..., 3:4].clone(),
                            "parse_cloth": a(2, 64, 64, 3)})
    else:
        trainer = gt.GeneratorTrainer(
            SPADEGenConfig(ngf=16, fine_height=512, fine_width=256),
            SPADEDiscriminatorConfig(ndf=8), GeneratorTrainConfig(bf16=True),
            PipelineConfig(fine_height=512, fine_width=256, cond_height=128,
                           cond_width=64), TOCGConfig(ngf=8), device="cuda")
        if schedule is not None:
            trainer.schedule = schedule
        state = trainer.init(seed)
        with torch.no_grad():
            for name, p in state.g.module.named_parameters():
                if name.endswith("noise_scale"):
                    p.fill_(0.2)
        tocg = ConditionGenerator(TOCGConfig(ngf=8), device="cuda").eval()
        init_weights(tocg, torch.Generator().manual_seed(3))
        frozen = {"vgg": vgg, "tocg": tocg.requires_grad_(False)}
        noise = torch.Generator(device="cuda").manual_seed(seed + 1)
        gens = [noise]
        step = lambda b: trainer.train_step(state, b, noise, noise, frozen)[1]
        batches = []
        for _ in range(3):
            a = lambda c: torch.tanh(_a(rng, (2, 512, 256, c)))
            labels = torch.from_numpy(rng.integers(0, 13, (2, 512, 256))).cuda()
            batches.append({"cloth": a(3), "cloth_mask": a(1) * 0.5 + 0.5,
                            "parse_agnostic": a(13), "densepose": a(3),
                            "agnostic": a(3), "image": a(3),
                            "parse": torch.nn.functional.one_hot(labels,
                                                                 13).float(),
                            "parse_cloth": a(3)})
    return dict(step=step, gens=gens, batches=batches, trainer=trainer,
                state=state, frozen=None if stage == "condition" else frozen,
                tensors=lambda: ct.net_tensors(state.g, state.d),
                counts=lambda: (state.step, state.g.opt.count,
                                state.d.opt.count),
                capt=(ct if stage == "condition" else gt)._step)


def _deterministic(monkeypatch):
    """cuDNN's deterministic algorithms for a test (two runs of one step
    must sum alike)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


def _eager_steps(run, batches):
    from hrviton_tpu_torch.core import graphs
    with graphs.disabled():
        return [run["step"](b) for b in batches]


def _distance(a, b):
    """The sum over two states' tensors of mean|x - y| / mean|y|."""
    return sum((x.float() - y.float()).abs().mean().item()
               / y.float().abs().mean().item()
               for x, y in zip(a, b) if y.float().abs().mean().item() > 0)


def _varying(state):
    """Per tensor of ``net_tensors(state.g, state.d)``: whether the stage-1
    step's nondeterministic op (the atomic adds of grid_sample's backward)
    reaches it, i.e. it is one of the tocg's parameters or their Adam
    moments."""
    from hrviton_tpu_torch.train import condition_trainer as ct
    g = state.g
    ids = {id(p) for p in g.module.parameters()}
    ids |= {id(g.opt.opt.state[p][k]) for p in g.opt.params
            for k in ("exp_avg", "exp_avg_sq")}
    return [id(t) in ids for t in ct.net_tensors(state.g, state.d)]


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["condition", "generator"])
def test_training_step_replay_equals_eager(stage, monkeypatch):
    """Three replayed steps against three eager steps (graphs.disabled())
    from the same state, capturable Adam on both sides, one recording, the
    generators' states equal after every step: stage 2 (bf16, the fused
    unit) bit for bit in every metric, parameter, buffer, Adam moment and
    step count and the counters. Stage 1's eager step is not reproducible
    on the card (the atomic adds of grid_sample's backward), so it is held
    step by step: before each step a second eager state and the first are
    set to the replayed one; after it every metric of the three and every
    tensor but the tocg's parameters and their Adam moments (the tocg's
    running statistics, the discriminator and its Adam state, the step
    counts) are equal bit for bit, and those within 4 times the two eager
    runs' distance (the sum over the tensors of mean|x - y| / mean|y|)."""
    _need_card()
    _deterministic(monkeypatch)
    runs = [_train_state(stage) for _ in range(3 if stage == "condition" else 2)]
    eager, rep = runs[0], runs[1]
    batches = eager["batches"]
    caps = rep["capt"].captures
    varies = _varying(rep["state"])
    for i, b in enumerate(batches):
        if stage == "condition" and i:
            with torch.no_grad():
                for run in (eager, runs[2]):
                    for x, y in zip(run["tensors"](), rep["tensors"]()):
                        x.copy_(y)
        got = rep["step"](b)
        want = [_eager_steps(run, [b])[0] for run in runs if run is not rep]
        for w in want:
            for k in w:
                assert torch.equal(got[k], w[k]), (i, k)
        for other in runs:
            for a, c in zip(rep["gens"], other["gens"]):
                assert torch.equal(a.get_state(), c.get_state()), i
        if stage == "condition":
            s_r, s_e, s_2 = (run["tensors"]() for run in (rep, eager, runs[2]))
            for x, y, z, var in zip(s_r, s_e, s_2, varies):
                if not var:
                    assert torch.equal(x, y) and torch.equal(x, z), i
            pick = lambda s: [t for t, var in zip(s, varies) if var]
            d_ee = _distance(pick(s_2), pick(s_e))
            d_re = max(_distance(pick(s_r), pick(s_e)),
                       _distance(pick(s_r), pick(s_2)))
            assert d_re <= 4.0 * d_ee or d_re == 0.0, (i, d_re, d_ee)
    torch.cuda.synchronize()
    assert rep["capt"].captures == caps + 1
    assert rep["counts"]() == eager["counts"]() == (3, 3, 3)
    steps = [s["step"] for s in rep["state"].g.opt.opt.state.values()]
    assert all(float(s) == 3.0 for s in steps)
    if stage == "generator":
        for x, y in zip(rep["tensors"](), eager["tensors"]()):
            assert torch.equal(x, y)


@pytest.mark.gpu
def test_step_and_generate_share_one_pool(monkeypatch):
    """The stage-2 step's graph and generate's share one memory pool:
    generating and stepping in turns (generate recorded first, so the
    step's recording may take what generate's graph leaves free), replayed,
    equals the same eagerly bit for bit, outputs, state and the gradients
    left in ``.grad`` after a generate replay (they live outside the
    pool)."""
    _need_card()
    _deterministic(monkeypatch)
    from hrviton_tpu_torch.core import graphs
    from hrviton_tpu_torch.train import generator_trainer as gt

    def turns(run):
        noise = torch.Generator(device="cuda").manual_seed(9)
        gen = lambda b: run["trainer"].generate(run["state"], b, noise,
                                                run["frozen"]["tocg"])
        b = run["batches"]
        return [gen(b[0]), run["step"](b[0]), gen(b[1]), run["step"](b[1]),
                gen(b[2])]

    eager, rep = _train_state("generator"), _train_state("generator")
    with graphs.disabled():
        want = turns(eager)
    got = turns(rep)
    assert gt._step.pool is not None and gt._step.pool == gt._generate_graph.pool
    for g, w in zip(got, want):
        for k in (w if isinstance(w, dict) else [None]):
            a, c = (g, w) if k is None else (g[k], w[k])
            assert torch.equal(a, c), k
    for x, y in zip(rep["tensors"](), eager["tensors"]()):
        assert torch.equal(x, y)
    for p, q in zip(rep["state"].g.opt.params + rep["state"].d.opt.params,
                    eager["state"].g.opt.params + eager["state"].d.opt.params):
        assert torch.equal(p.grad, q.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("b1,b2", [(0.5, 0.999), (0.0, 0.9)])
def test_capturable_adam_matches_plain_adam(b1, b2):
    """The port's Adam on the card (capturable, a device learning rate)
    against torch's plain Adam (a float rate, the CPU tests' optimizer) on
    the same gradients: after three updates with a changing rate the
    parameters and moments agree within 1e-6 x max|ref| (f32: the same
    update in another order of operations)."""
    _need_card()
    from hrviton_tpu_torch.train.optim import adam
    rng = np.random.default_rng(12)
    p0 = _a(rng, (64, 33))
    grads = [_a(rng, (64, 33), 0.1) for _ in range(3)]
    pa = torch.nn.Parameter(p0.clone())
    pb = torch.nn.Parameter(p0.clone())
    opt_a = adam([pa], 1e-3, b1, b2, schedule=lambda c: 1.0 / (1 + c))
    opt_b = torch.optim.Adam([pb], lr=1e-3, betas=(b1, b2), eps=1e-8,
                             capturable=False, foreach=False)
    assert opt_a.capturable
    for i, g in enumerate(grads):
        pa.grad, pb.grad = g, g.clone()
        opt_a.step()
        opt_b.param_groups[0]["lr"] = 1e-3 / (1 + i)
        opt_b.step()
    for x, y in [(pa, pb)] + [(opt_a.opt.state[pa][k], opt_b.state[pb][k])
                              for k in ("exp_avg", "exp_avg_sq")]:
        err = (x.detach() - y.detach()).abs().max().item()
        assert err <= 1e-6 * y.detach().abs().max().item(), err
    assert float(opt_a.opt.state[pa]["step"]) == 3.0 and opt_a.count == 3


@pytest.mark.gpu
def test_training_step_recaptures_after_a_load(monkeypatch):
    """Weights loaded in place into the generator after two replayed steps
    (load_jax_variables) record the step anew, and the next step equals the
    eager step after the same load, bit for bit; a learning rate that
    changes every update is read by the replays."""
    _need_card()
    _deterministic(monkeypatch)
    from hrviton_tpu_torch.convert import (export_jax_variables,
                                           load_jax_variables)
    from hrviton_tpu_torch.nn.layers import init_weights
    schedule = lambda c: 1.0 / (1 + c)
    eager = _train_state("generator", schedule=schedule)
    rep = _train_state("generator", schedule=schedule)
    other = _train_state("generator", seed=5)["state"].g.module
    init_weights(other, torch.Generator().manual_seed(11))
    tree = export_jax_variables(other)
    b = rep["batches"]
    caps = rep["capt"].captures
    got = [rep["step"](b[0]), rep["step"](b[1])]
    assert rep["capt"].captures == caps + 1
    load_jax_variables(rep["state"].g.module, tree)
    got.append(rep["step"](b[2]))
    assert rep["capt"].captures == caps + 2
    want = _eager_steps(eager, b[:2])
    load_jax_variables(eager["state"].g.module, tree)
    want += _eager_steps(eager, b[2:])
    for m, n in zip(got, want):
        for k in n:
            assert torch.equal(m[k], n[k]), k
    for x, y in zip(rep["tensors"](), eager["tensors"]()):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_fused_block_step_launches_18_units():
    """A replayed stage-2 step with the fused unit launches it 18 times
    (the G loss's forward, the remat recompute, the D step's regeneration)
    and the statistics 18 times, as the eager step does; the graph holds 18
    nodes of each of the unit's two kernels."""
    _need_card()
    import os
    import tempfile
    run = _train_state("generator")
    b = run["batches"][0]
    counts = lambda: (tsb.spade_conv_unit.launches, tsf.norm_stats.launches)
    before = counts()
    _eager_steps(run, [b])
    eager = tuple(x - y for x, y in zip(counts(), before))
    run["step"](b)
    before = counts()
    run["step"](b)
    torch.cuda.synchronize()
    assert eager == tuple(x - y for x, y in zip(counts(), before)) == (18, 18)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "step.dot")
        run["capt"].last_entry.graph.debug_dump(path)
        dot = open(path).read()
    assert dot.count("spade_unit_gb_kernel") == 18
    assert dot.count("spade_unit_conv_kernel") == 18


@pytest.mark.gpu
def test_recorded_backward_runs_without_tf32(monkeypatch):
    """Stage 1 in f32 recorded under torch's default TF32 settings: the
    logit hooks, which run while the step is warmed up and recorded, read
    TF32 off in backward; the caller's settings are back after the call."""
    _need_card()
    from hrviton_tpu_torch.train import condition_trainer as ct
    seen = []
    real = ct.lsgan_loss

    def spy(pred, *a, **k):
        for p in pred:
            t = p[-1] if isinstance(p, (list, tuple)) else p
            if t.requires_grad:
                t.register_hook(lambda g: seen.append(
                    (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)) or g)
        return real(pred, *a, **k)
    monkeypatch.setattr(ct, "lsgan_loss", spy)
    run = _train_state("condition")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    caps = run["capt"].captures
    run["step"](run["batches"][0])
    after = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    _need_card()                                 # the file's TF32 settings
    assert run["capt"].captures == caps + 1
    assert len(seen) >= 4 and set(seen) == {(False, False)}
    assert after == (True, True)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["thread_local", "global", "relaxed"])
def test_step_records_under_each_capture_mode(monkeypatch, mode):
    """A stage-2 step (torch.autograd.grad, blocks recomputed under
    torch.utils.checkpoint in the autograd engine's thread, the fused unit)
    records under each capture_error_mode and replays eager's step."""
    _need_card()
    _deterministic(monkeypatch)
    from hrviton_tpu_torch.core import graphs
    monkeypatch.setattr(graphs, "CAPTURE_ERROR_MODE", mode)
    eager, rep = _train_state("generator"), _train_state("generator")
    b = eager["batches"][0]
    caps = rep["capt"].captures
    got = rep["step"](b)
    want = _eager_steps(eager, [b])[0]
    assert rep["capt"].captures == caps + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for x, y in zip(rep["tensors"](), eager["tensors"]()):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_a_step_records_again_after_its_graphs_died(monkeypatch):
    """Once a step's graphs have died with their trainer and the cache was
    emptied, a new trainer's step records into a new pool and replays
    eager's step (a pool whose graphs all died cannot take another)."""
    _need_card()
    _deterministic(monkeypatch)
    import gc
    run = _train_state("generator")
    run["step"](run["batches"][0])
    capt = run["capt"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    assert not capt.entries and capt.last_entry is None
    eager, rep = _train_state("generator"), _train_state("generator")
    b = eager["batches"][0]
    got = rep["step"](b)
    want = _eager_steps(eager, [b])[0]
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------ the bf16 weight gradient (wgrad3x3)

def _wgrad_sites():
    """The 47 distinct (N, H, W, Cin, Cout, pre_act) of the training cell's
    94 weight gradients a step (tests/test_torch_wgrad3x3.py:cell_sites)."""
    from test_torch_wgrad3x3 import cell_sites
    return sorted(set(cell_sites()), key=lambda s: (s[1], s[3], s[4], str(s[5])))


def _wgrad_operands(n, h, w, cin, cout, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, w, cin, device="cuda", generator=gen).bfloat16()
    g = (torch.randn(n, h, w, cout, device="cuda", generator=gen) * 0.1).bfloat16()
    return x, g


def _wgrad_layout(g, layout):
    """g (N, H, W, C) as the step's backward may hand it over: contiguous
    NHWC; the NHWC view of a contiguous NCHW tensor; or of the last C
    channels of a wider NCHW tensor (a concatenation's gradient)."""
    if layout == "nchw":
        return g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    if layout == "slice":
        n, h, w, c = g.shape
        wide = torch.zeros(n, c + 16, h, w, dtype=g.dtype, device=g.device)
        wide[:, 16:] = g.permute(0, 3, 1, 2)
        return wide[:, 16:].permute(0, 2, 3, 1)
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nhwc", "nchw", "slice"])
@pytest.mark.parametrize("site", range(47))
def test_wgrad3x3_matches_plain_at_the_cells_shapes(site, layout):
    """The kernel against ``wgrad3x3_ref`` (act in bf16, f32 products and
    sums, one rounding to bf16) at each distinct shape of the training
    cell's 94 calls, batch 2, with g in each layout ``_wgrad_layout`` makes
    (most of the step's arrive NCHW): every element within one bf16 ulp,
    with the card's floor for elements near zero
    (tests/test_torch_wgrad3x3.py; only the order and the rounding of the
    f32 sums differ); one launch counted."""
    _need_card()
    from test_torch_wgrad3x3 import assert_within_one_ulp
    sites = _wgrad_sites()
    assert len(sites) == 47
    n, h, w, cin, cout, pre_act = sites[site]
    x, g = _wgrad_operands(n, h, w, cin, cout, seed=site)
    g = _wgrad_layout(g, layout)
    before = tc3.wgrad3x3.launches
    got = tc3.wgrad3x3(x, g, pre_act, torch.bfloat16)
    torch.cuda.synchronize()
    assert tc3.wgrad3x3.launches == before + 1
    assert got.shape == (cout, cin, 3, 3) and got.dtype == torch.bfloat16
    assert_within_one_ulp(got, tc3.wgrad3x3_ref(x, g, pre_act, torch.bfloat16),
                          floor=2.0 ** -12)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (2, 1024, 768, 128, 80, "relu"),      # x on M, the pixels split over 66 blocks
    (2, 16, 12, 1040, 1024, "leaky0.2"),  # one split: the block rounds dW itself
    (2, 37, 45, 80, 48, "leaky0.2"),      # ragged rows, columns and channels
    (2, 64, 48, 7, 128, None),            # g on M; x read from its padded copy
    (2, 64, 48, 32, 3, "leaky0.2")])      # g padded (NHWC) or read as it is (NCHW)
@pytest.mark.parametrize("layout", ["nhwc", "nchw", "slice"])
def test_wgrad3x3_two_launches_are_bit_identical(shape, layout):
    """The partial sums are added in a fixed order: two launches give the
    same bits, in bf16 and in f32 output; the f32 output rounds to the bf16
    one, and lies within 2^-12 of max|exact| of the exact sum (the plain
    version's products summed in float64; the tensor cores' f32 sums,
    tests/test_torch_wgrad3x3.py)."""
    _need_card()
    n, h, w, cin, cout, pre_act = shape
    x, g = _wgrad_operands(n, h, w, cin, cout, seed=7)
    g = _wgrad_layout(g, layout)
    for dtype in (torch.bfloat16, torch.float32):
        a = tc3.wgrad3x3(x, g, pre_act, dtype)
        b = tc3.wgrad3x3(x, g, pre_act, dtype)
        torch.cuda.synchronize()
        assert torch.equal(a, b), dtype
    assert torch.equal(a.bfloat16(), tc3.wgrad3x3(x, g, pre_act, torch.bfloat16))
    pad = torch.nn.functional.pad(tc3.activation(x, pre_act).double(),
                                  (0, 0, 1, 1, 1, 1))
    gd = g.double().reshape(-1, cout)
    exact = torch.stack([pad[:, ky:ky + h, kx:kx + w].reshape(-1, cin).t() @ gd
                         for ky in range(3) for kx in range(3)])
    exact = exact.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    assert (a - exact).abs().max().item() <= exact.abs().max().item() * 2.0 ** -12


@pytest.mark.gpu
def test_wgrad3x3_rejects_bad_input():
    _need_card()
    x, g = _wgrad_operands(1, 16, 8, 16, 16)
    with pytest.raises(TypeError):
        tc3.wgrad3x3(x.float(), g)
    with pytest.raises(ValueError):
        tc3.wgrad3x3(x, g[:, :8])
    with pytest.raises(ValueError):
        tc3.wgrad3x3(x, g.cpu())


@pytest.mark.gpu
def test_wgrad3x3_in_the_recorded_stage2_step():
    """The training cell's step (benchmark/configs/hrviton-train-stage2-
    bf16.json, built by benchmark/drivers/train_closed_loop.py: SPADE ngf
    64 'most' at 1024x768, batch 2, bf16): an eager step takes the kernel 94 times, at
    the cell's 47 shapes as often as the generator has them; then the step
    is recorded, and a replay adds 94 to ``wgrad3x3.launches`` and to
    ``wgrad_taps.launches`` alike, its losses finite. The taps op's
    backward runs 107 times a step (G's 94 convs and VGG19's 13 on G's
    output), eager and replayed, and no input gradient finds g in a layout
    other than x's (``conv3x3_taps.layout_copies`` adds 0)."""
    _need_card()
    import collections
    import json
    import os
    from benchmark import inputs
    from benchmark.drivers import train_closed_loop as tcl
    from hrviton_tpu_torch.cli import train_generator as tgen
    from hrviton_tpu_torch.core import graphs
    from test_torch_wgrad3x3 import cell_sites
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "benchmark")
    config = json.load(open(os.path.join(root, "configs",
                                         "hrviton-train-stage2-bf16.json")))
    traffic = json.load(open(os.path.join(root, "traffic", "train-closed-b2.json")))
    built = tcl.build(config, traffic, 11, "cuda")
    p = config["pipeline"]
    pool = inputs.make_pool(2, 2, p["fine_height"], p["fine_width"], 12, "cuda")
    seen = []
    real = tc3.wgrad3x3_launcher

    def spy(x, g, pre_act=None, dtype=torch.bfloat16):
        seen.append((*x.shape, g.shape[-1], pre_act))
        return real(x, g, pre_act, dtype)
    state = built.state

    def step(raw):
        out = tgen.train_step(built.trainer, state, raw, built.noise,
                              built.frozen, built.put)
        torch.cuda.synchronize()
        assert all(torch.isfinite(v).all() for v in out.metrics.values())
        return out.state
    counts = lambda: (tc3.wgrad3x3.launches, tc3.wgrad_taps.launches,
                      tc3.conv3x3_taps.backwards.launches,
                      tc3.conv3x3_taps.layout_copies.launches)
    tc3.wgrad3x3_launcher = spy
    try:
        with graphs.disabled():
            before = counts()
            state = step(pool[0])
            eager = tuple(a - b for a, b in zip(counts(), before))
    finally:
        tc3.wgrad3x3_launcher = real
    assert eager == (94, 94, 107, 0)
    assert collections.Counter(seen) == collections.Counter(cell_sites())
    state = step(pool[1])                 # records the step's graph
    before = counts()
    state = step(pool[0])                 # a replay
    assert tuple(a - b for a, b in zip(counts(), before)) == (94, 94, 107, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("g_layout", [torch.channels_last, torch.contiguous_format])
@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_taps_backward_on_the_card_follows_x_layout(dtype, pre_act, g_layout):
    """On the card, x channels_last (128 -> 80 channels, as up_4's gamma
    conv): the taps op's input gradient is channels_last. bf16: the
    derivative applied to cuDNN's NHWC dgrad is the product with the
    rounded mask bit for bit, and against the NCHW formula the op used
    before (cuDNN's NCHW dgrad; the bias from an f32 copy of g) the input
    and bias gradients lie within one bf16 ulp (two f32 sums in another
    order, each rounded once). f32 (TF32 off): that formula's gradients
    bit for bit, the input gradient laid out as x. Layout copies: bf16 one
    for a g in the other layout; f32 one for a g that is not NCHW and one
    for the result laid out as x."""
    _need_card()
    from hrviton_tpu_torch.core import precision
    from test_torch_wgrad3x3 import _bits, _parent_grads, assert_within_one_ulp
    gen = torch.Generator(device="cuda").manual_seed(26)
    draw = lambda *shape, scale=1.0: (torch.randn(
        shape, generator=gen, device="cuda") * scale).to(dtype)
    cl = torch.channels_last
    x = draw(2, 128, 64, 48).contiguous(memory_format=cl).requires_grad_()
    w = draw(80, 128, 3, 3, scale=0.03).requires_grad_()
    b = draw(80, scale=0.1).requires_grad_()
    g = draw(2, 80, 64, 48).contiguous(memory_format=g_layout)
    before = (tc3.conv3x3_taps.backwards.launches,
              tc3.conv3x3_taps.layout_copies.launches)
    gx, gb = torch.autograd.grad(tc3.conv3x3_taps(x, w, b, pre_act), (x, b), g)
    assert (tc3.conv3x3_taps.backwards.launches - before[0],
            tc3.conv3x3_taps.layout_copies.launches - before[1]) == (
                1, (g_layout != cl) if dtype == torch.bfloat16
                else (g_layout != torch.contiguous_format) + 1)
    assert gx.dtype == dtype and gx.is_contiguous(memory_format=cl)
    xd, wd = x.detach(), w.detach()
    with precision.exact(dtype):
        parent_x, parent_b = _parent_grads(xd, wd, g, pre_act)
        nhwc = torch.ops.aten.convolution_backward(
            g, xd, wd, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            (True, False, False))[0]
    if dtype == torch.float32:
        assert torch.equal(_bits(gx), _bits(parent_x))
        assert torch.equal(_bits(gb), _bits(parent_b))
        return
    want_x, _ = _parent_grads(xd, wd, g, pre_act, nhwc)
    assert torch.equal(_bits(gx), _bits(want_x))
    assert_within_one_ulp(gx, parent_x, 2.0 ** -12)
    assert_within_one_ulp(gb, parent_b, 2.0 ** -12)
