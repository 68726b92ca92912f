"""The weight gradient of a library 3x3 conv under ``taps_wgrad``, on the CPU.

``ops/conv3x3.wgrad_taps`` sends bf16 on the card to the kernel
``wgrad3x3`` (``csrc/wgrad3x3.cu``: bf16 products on wgmma, f32 sums, one
rounding), bf16 on the CPU to its plain version ``wgrad3x3_ref``, and f32
to the f32 tap products over row chunks (``_wgrad_rows``), as before. Here:
the plain version against that f32 path rounded to bf16 (the same exact
bf16 products; only the order of the f32 sum differs), the dispatch (a
stand-in launcher for the card), the tile roles and splits the kernel takes
at the benchmark cell's 94 calls, the wrapper's refusals, and the taps
op's backward in x's memory format against its earlier formulas. The kernel
itself is held to ``wgrad3x3_ref`` on the card (``tests/test_torch_cuda.py``,
``-m gpu``). Imports no JAX.

One bf16 ulp: |got - want| at most one ulp of bf16 at the larger magnitude,
or a floor for an element whose sum ends near zero, where two f32 sums in
another order differ by their own rounding, far below an ulp of the
tensor's magnitude, and a bf16 ulp of a near-zero value is smaller still:
2^-16 of max|want| for two sums of the CPU (round to nearest), 2^-12 on the
card, whose tensor cores keep the f32 sum of each block's chain (up to
47,744 pixels) less exactly (measured 4.3e-5 of max|exact| at up_4's largest
call: 5.7x below 2^-12; 1/16 to 1/32 of the ulp of the largest element).
"""

import pytest
import torch

from hrviton_tpu_torch.config import SPADEGenConfig
from hrviton_tpu_torch.models.spade import SPADEGenerator
from hrviton_tpu_torch.ops import conv3x3 as tc3

BF16 = torch.bfloat16
_CHANNELS = (3, 7, 9, 16, 80)


def cell_sites(batch=2, h=1024, w=768):
    """(N, H, W, Cin, Cout, pre_act) of each 3x3 weight gradient one
    stage-2 step of the benchmark's training cell takes (SPADE ngf 64
    'most' at 1024x768, batch 2), from the generator's modules: a block's
    input-pyramid conv (9 -> 1024 at the head, 9 -> 16 after), each norm's
    shared conv (7 -> 128) and its gamma and beta (128 -> C, relu),
    conv_0 and conv_1 (leaky 0.2), and conv_img (32 -> 3, leaky 0.2)."""
    gen = SPADEGenerator(SPADEGenConfig(ngf=64), device="meta")
    names = gen.block_names
    shape = lambda conv: tuple(conv.weight.shape[1::-1])         # (Cin, Cout)
    sites = []
    for i, name in enumerate(names):
        bh, bw = h >> (len(names) - 1 - i), w >> (len(names) - 1 - i)
        at = lambda conv, act: (batch, bh, bw, *shape(conv), act)
        sites.append(at(getattr(gen, f"conv_{i}"), None))
        for sub, mod in getattr(gen, name).named_children():
            if sub.startswith("norm"):
                sites.append(at(mod.conv_shared, None))
                sites += [at(mod.conv_gamma, "relu"), at(mod.conv_beta, "relu")]
            elif tuple(mod.weight.shape[-2:]) == (3, 3):
                sites.append(at(mod, "leaky0.2"))
    sites.append((batch, h, w, *shape(gen.conv_img), "leaky0.2"))
    return sites


def _bf16(shape, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * scale).to(BF16)


def assert_within_one_ulp(got, want, floor=2.0 ** -16):
    """The module docstring's one bf16 ulp, element by element; ``floor``
    of max|want| for the elements near zero."""
    g, w = got.float(), want.float()
    # mag = m 2^e with m in [0.5, 1) (frexp, exact where log2 may round):
    # bf16's 8 significant bits put its ulp at 2^(e - 8)
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    limit = torch.ldexp(torch.ones_like(g), e - 8) + w.abs().max() * floor
    bad = (g - w).abs() > limit
    assert not bad.any(), (f"{int(bad.sum())} of {bad.numel()} elements beyond "
                           f"one bf16 ulp; worst {float((g - w).abs().max())}")


@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
@pytest.mark.parametrize("cout", _CHANNELS)
@pytest.mark.parametrize("cin", _CHANNELS)
def test_plain_matches_the_f32_row_chunks(cin, cout, pre_act):
    """bf16 x and g: ``wgrad3x3_ref`` rounded to bf16 against the f32 path
    (row chunks of 4 at h = 12) rounded to bf16, within one bf16 ulp."""
    x, g = _bf16((2, 12, 10, cin), 1), _bf16((2, 12, 10, cout), 2, 0.1)
    got = tc3.wgrad3x3_ref(x, g, pre_act, BF16)
    want = tc3._wgrad_rows(x, g, pre_act).to(BF16)
    assert got.shape == (cout, cin, 3, 3) and got.dtype == BF16
    assert_within_one_ulp(got, want)


@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
def test_plain_is_the_convolutions_weight_gradient(pre_act):
    """In f32 the plain version is the library's weight gradient of the conv
    of act(x), in float64 (the sum's order apart)."""
    x, g = torch.randn(2, 9, 11, 6), torch.randn(2, 9, 11, 5)
    a = tc3.activation(x.double(), pre_act).permute(0, 3, 1, 2)
    want = torch.nn.grad.conv2d_weight(a, (5, 6, 3, 3),
                                       g.double().permute(0, 3, 1, 2), padding=1)
    got = tc3.wgrad3x3_ref(x, g, pre_act)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype, device, path", [
    (BF16, "cuda", "kernel"), (BF16, "cpu", "plain"), (torch.float32, "cuda", "rows"),
    (torch.float32, "cpu", "rows"), (torch.float16, "cuda", "rows")])
def test_wgrad_path(dtype, device, path):
    """bf16 on the card takes the kernel, bf16 on the CPU the plain version,
    every other dtype the f32 row chunks (tensor cores would need TF32)."""
    assert tc3.wgrad_path(dtype, torch.device(device)) == path


def test_wgrad_taps_sends_bf16_on_the_card_to_the_kernel(monkeypatch):
    """Through a stand-in launcher (the card's path taken on the CPU): one
    launch, counted on ``wgrad3x3`` and ``wgrad_taps``, its output returned
    in the dtype asked for."""
    calls = []

    def launcher(x, g, pre_act=None, dtype=BF16):
        out = torch.empty((g.shape[-1], x.shape[-1], 3, 3), dtype=dtype)
        launch = lambda: calls.append(pre_act) or out.copy_(
            tc3.wgrad3x3_ref(x, g, pre_act, dtype))
        return launch, out
    monkeypatch.setattr(tc3, "wgrad3x3_launcher", launcher)
    monkeypatch.setattr(tc3, "wgrad_path", lambda dtype, device: "kernel")
    x, g = _bf16((2, 8, 8, 16), 3), _bf16((2, 8, 8, 7), 4)
    before = tc3.wgrad3x3.launches, tc3.wgrad_taps.launches
    got = tc3.wgrad_taps(x, g, "leaky0.2", BF16)
    assert calls == ["leaky0.2"]
    assert (tc3.wgrad3x3.launches, tc3.wgrad_taps.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == BF16 and torch.equal(
        got, tc3.wgrad3x3_ref(x, g, "leaky0.2", BF16))


def test_wgrad_taps_takes_the_path_of_x_alone(monkeypatch):
    """The path is x's: bf16 x with an f32 g on the card goes to the
    kernel's wrapper, which refuses it (no second route to the f32 row
    chunks)."""
    asked = []

    def launcher(x, g, pre_act=None, dtype=BF16):
        if g.dtype != x.dtype:
            raise TypeError(f"wgrad3x3 takes bfloat16, got {x.dtype}, {g.dtype}")
    monkeypatch.setattr(tc3, "wgrad3x3_launcher", launcher)
    monkeypatch.setattr(tc3, "wgrad_path",
                        lambda dtype, device: asked.append(dtype) or "kernel")
    x, g = _bf16((2, 8, 8, 16), 3), torch.randn(2, 8, 8, 8)
    with pytest.raises(TypeError):
        tc3.wgrad_taps(x, g, None, BF16)
    assert asked == [BF16]


@pytest.mark.parametrize("pre_act", [None, "leaky0.2"])
def test_wgrad_taps_keeps_f32_on_the_row_chunks(pre_act):
    """f32 takes the f32 tap products over row chunks, bit for bit; bf16 on
    the CPU the plain version, bit for bit; neither launches the kernel."""
    before = tc3.wgrad3x3.launches
    x, g = torch.randn(2, 16, 10, 6), torch.randn(2, 16, 10, 5)
    assert torch.equal(tc3.wgrad_taps(x, g, pre_act),
                       tc3._wgrad_rows(x, g, pre_act))
    xb, gb = x.to(BF16), g.to(BF16)
    got = tc3.wgrad_taps(xb, gb, pre_act, BF16)
    assert got.dtype == BF16
    assert torch.equal(got, tc3.wgrad3x3_ref(xb, gb, pre_act, BF16))
    assert tc3.wgrad3x3.launches == before


def test_taps_backward_writes_w_dtype_once():
    """The taps op's weight gradient in bf16 is the plain version rounded
    once to w's dtype; its input gradient is unchanged by the weight's
    path."""
    x = _bf16((2, 12, 10, 8), 5).permute(0, 3, 1, 2).requires_grad_()
    w = _bf16((4, 8, 3, 3), 6, 0.1).requires_grad_()
    g = _bf16((2, 4, 12, 10), 7)
    tc3.conv3x3_taps(x, w, None, "relu").backward(g)
    want = tc3.wgrad3x3_ref(x.detach().permute(0, 2, 3, 1),
                            g.permute(0, 2, 3, 1), "relu", BF16)
    assert w.grad.dtype == BF16 and torch.equal(w.grad, want)


CL = torch.channels_last


def _parent_grads(x, w, g, pre_act, dgrad=None):
    """The taps op's input and bias gradients by the formulas it used
    before its backward followed x's layout: the library's dgrad with a
    placeholder input (NCHW; or ``dgrad`` given), the pre-activation's
    derivative as a product with the mask rounded to the dgrad's dtype, and
    the bias gradient from an f32 copy of g."""
    da = (torch.nn.grad.conv2d_input(x.shape, w, g, padding=1)
          if dgrad is None else dgrad)
    if pre_act == "relu":
        da = da * (x > 0).to(da.dtype)
    elif pre_act == "leaky0.2":
        da = da * torch.where(x > 0, 1.0, tc3.leaky_slope(da.dtype)).to(da.dtype)
    return da.to(x.dtype), g.float().sum(dim=(0, 2, 3)).to(w.dtype)


def spy_taps_backward(monkeypatch):
    """Wraps the taps op's backward; returns the list it fills, a tuple a
    call: (an input gradient taken, x channels_last, g channels_last)."""
    seen, real = [], (tc3._Taps.forward, tc3._Taps.backward)

    def forward(ctx, x, *args):
        # x's layout noted here: under remat the saved tensors unpack once
        ctx.spy_x_cl = x.is_contiguous(memory_format=CL)
        return real[0](ctx, x, *args)

    def backward(ctx, g):
        seen.append((ctx.needs_input_grad[0], ctx.spy_x_cl,
                     g.is_contiguous(memory_format=CL)))
        return real[1](ctx, g)
    monkeypatch.setattr(tc3._Taps, "forward", staticmethod(forward))
    monkeypatch.setattr(tc3._Taps, "backward", staticmethod(backward))
    return seen


def _bits(t):
    """t's bit patterns (a -0 is not a 0 here), in a contiguous copy."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


@pytest.mark.parametrize("g_layout", [CL, torch.contiguous_format])
@pytest.mark.parametrize("x_layout", [CL, torch.contiguous_format])
@pytest.mark.parametrize("pre_act", [None, "relu", "leaky0.2"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_taps_backward_follows_x_layout(dtype, pre_act, x_layout, g_layout):
    """The taps op's input gradient comes out in x's memory format, and
    its three gradients are the parent's formulas' bit for bit (bf16: the
    library's dgrad in x's layout sums as the NCHW one does on the CPU;
    f32: the NCHW dgrad laid out as x). The backward counts one call, and
    the layout copies its input gradient makes: bf16 one where g is laid
    out otherwise than x; f32 one where g is not NCHW (the dgrad's input)
    and one where x is channels_last (the dgrad's result)."""
    gen = torch.Generator().manual_seed(13)
    draw = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen)
                                      * scale).to(dtype)
    x = draw(2, 8, 12, 10).contiguous(memory_format=x_layout).requires_grad_()
    w = draw(6, 8, 3, 3, scale=0.1).requires_grad_()
    b = draw(6, scale=0.1).requires_grad_()
    g = draw(2, 6, 12, 10).contiguous(memory_format=g_layout)
    before = (tc3.conv3x3_taps.backwards.launches,
              tc3.conv3x3_taps.layout_copies.launches)
    y = tc3.conv3x3_taps(x, w, b, pre_act)
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), g)
    copied = ((g_layout != x_layout) if dtype == BF16
              else (g_layout != torch.contiguous_format) + (x_layout == CL))
    assert (tc3.conv3x3_taps.backwards.launches - before[0],
            tc3.conv3x3_taps.layout_copies.launches - before[1]) == (1, copied)
    assert gx.is_contiguous(memory_format=x_layout) and gx.dtype == dtype
    xd, wd = x.detach(), w.detach()
    want_x, want_b = _parent_grads(xd, wd, g, pre_act)
    assert torch.equal(_bits(gx), _bits(want_x))
    assert torch.equal(_bits(gb), _bits(want_b))
    want_w = tc3.wgrad_taps(xd.permute(0, 2, 3, 1),
                            g.contiguous().permute(0, 2, 3, 1), pre_act, dtype)
    assert torch.equal(_bits(gw), _bits(want_w))


def test_cell_sites_are_the_steps_94():
    """The generator's 3x3 convs with weight gradients: 94 a step
    (``benchmark.drivers.train_closed_loop.taps_per_step``), 47 shapes."""
    sites = cell_sites()
    assert len(sites) == 94 and len(set(sites)) == 47
    assert (2, 1024, 768, 128, 80, "relu") in sites
    assert {s[3] for s in sites} == {7, 9, 32, 64, 80, 128, 144, 256, 272,
                                     512, 528, 1024, 1040}
    assert {s[4] for s in sites} == {3, 16, 32, 64, 80, 128, 144, 256, 272,
                                     512, 528, 1024, 1040}


@pytest.mark.parametrize("cin, cout, x_on_m, bn", [
    (128, 80, True, 48), (7, 128, False, 16), (1040, 1024, True, 64),
    (1024, 1024, True, 64), (128, 32, True, 32), (32, 3, True, 16),
    (528, 256, True, 64), (80, 32, True, 32), (144, 64, False, 48)])
def test_tile_roles_follow_the_shape(cin, cout, x_on_m, bn):
    """The larger padded side takes wgmma's M: x for 128 -> 80, g for
    7 -> 128."""
    assert tc3.wgrad3x3_tiles(cin, cout) == (x_on_m, bn)


def test_plans_at_the_cells_sites():
    """At each of the cell's shapes, on 132 SMs: an N tile the kernel is
    built for; a split per output tile where the tiles fill the card, and
    the pixels split where two tiles would leave it idle; at most one split
    per pixel tile; the operands' zero-padded copies counted; and the f32
    partials no larger than the bf16 operands they are summed from."""
    seen = set()
    for n, h, w, cin, cout, _ in set(cell_sites()):
        plan = tc3.wgrad3x3_plan(n, h, w, cin, cout, 132)
        assert plan["bn"] in tc3._WGRAD_BN, (h, cin, cout)
        pixel_tiles = n * -(-h // 16) * -(-w // 8)
        assert 1 <= plan["splits"] <= pixel_tiles
        if plan["tiles"] >= 132:
            assert plan["splits"] == 1, (h, cin, cout)
        if plan["tiles"] <= 2 and pixel_tiles >= 264:
            assert plan["tiles"] * plan["splits"] >= 128, (h, cin, cout)
        part = plan["splits"] * cout * cin * 9 * 4 if plan["splits"] > 1 else 0
        copies = n * h * w * 2 * ((cin % 8 and -cin % 8 + cin)
                                  + (cout % 8 and -cout % 8 + cout))
        assert plan["copies"] == copies
        assert part <= 2 * n * h * w * (cin + cout), (h, cin, cout, part)
        seen.add(plan["splits"] > 1)
    assert seen == {True, False}


def test_kernel_wrapper_refuses_what_it_cannot_launch():
    x, g = _bf16((1, 8, 8, 16), 8), _bf16((1, 8, 8, 16), 9)
    with pytest.raises(ValueError, match="CUDA"):
        tc3.wgrad3x3(x, g)
    with pytest.raises(ValueError, match="NHWC"):
        tc3.wgrad3x3(x, g[:, :4])
    with pytest.raises(ValueError):
        tc3.wgrad3x3(x, g, "gelu")
    with pytest.raises(TypeError):
        tc3.wgrad3x3(x, g, None, torch.int32)
