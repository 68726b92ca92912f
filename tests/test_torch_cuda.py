"""On the card: each hand-written CUDA kernel vs its plain version.

Imports no JAX (the machine with the card has none), so it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``; here,
without a card, each test skips.

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
    _need_card()
    # ragged 37x45 tiles exercise every edge mask of the 8x8 tiling
    args, res = _inputs(dtype, 2, 37, 45, 40, 24, ksize, residual)
    before = tsb.spade_conv_unit.launches
    got = tsb.spade_conv_unit(pre_act, *args, res)
    torch.cuda.synchronize()
    assert tsb.spade_conv_unit.launches == before + 1
    want = tsb.spade_conv_ref(*args, pre_act=pre_act, residual=res)
    _assert_close(got, want, dtype)


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
    """Ragged 37x45 (every edge mask of the engine's 8x32 and the f32 8x8
    tilings); in bf16 c = 40 is one N tile of 40 channels, c = 128 three of
    48 (the last part padding), c = 272 six of 48."""
    _need_card()
    args, _ = _inputs(dtype, 2, 37, 45, c, 8, 3, False)
    before = tsf.fused_spade_modulate.launches
    got = tsf.fused_spade_modulate(*args[:8])
    torch.cuda.synchronize()
    assert tsf.fused_spade_modulate.launches == before + 1
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
    _need_card()
    x, w, b = _conv_inputs(dtype, 2, 37, 45, cin, cout, bias)
    before = tc3.conv3x3_wide.launches
    got = tc3.conv3x3_wide(x, w, b, pre_act)
    torch.cuda.synchronize()
    assert tc3.conv3x3_wide.launches == before + 1
    _assert_close(got, tc3.conv3x3_ref(x, w, b, pre_act, fused_bias=True), dtype)


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
    bf16 input, which needs W * Cin % 8 == 0."""
    _need_card()
    narrow = dtype == torch.bfloat16 and cin % 8 and cin < 15
    x, w, b = _conv_inputs(dtype, 2, 37, 40 if narrow else 45, cin, cout, bias)
    before = tc3.conv3x3_small.launches
    got = tc3.conv3x3_small(x, w, b, pre_act)
    torch.cuda.synchronize()
    assert tc3.conv3x3_small.launches == before + 1
    _assert_close(got, tc3.conv3x3_ref(x, w, b, pre_act), dtype)


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
    """mu within 1e-4 of the channel's std, rsig within 1e-4 relative; C =
    13 takes the unvectorised loads."""
    _need_card()
    rng = np.random.default_rng(4)
    b, h, w, c = shape
    x = (_a(rng, shape) * 2 + 3).to(dtype)
    noise, nscale = _a(rng, (b, h, w, 1)), _a(rng, (c,), 0.1)
    before = tsf.norm_stats.launches
    mu, rsig = tsf.norm_stats(x, noise, nscale)
    torch.cuda.synchronize()
    assert tsf.norm_stats.launches == before + 1
    mu0, rsig0 = tsf.instance_stats(x, noise, nscale)
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
