"""The host side of the TMA / wgmma conv engine, on the CPU (no card needed).

Each weight packer is unpacked here by an independent numpy reading of the
layout the engine's kernels expect ((KP / 16, NP / BN, T, BN, 16): chunk of
16 input channels, N tile, tap, column, input channel; the two 16-byte
halves of a column exchanged where column & 4) and compared with the OIHW
weights bit for bit. The packing cache must re-pack after an in-place update
and not otherwise. The unit's two stages, composed in plain PyTorch, must
give ``spade_conv_ref`` bit for bit in bf16 (and within 1e-5 in f32): this
holds the split to the fused unit's rounding.
"""

import numpy as np
import pytest
import torch

from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.ops import conv_engine as ce
from hrviton_tpu_torch.ops import spade_block as tsb
from hrviton_tpu_torch.ops import spade_fused as tsf

torch.set_num_threads(1)


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _unpack(wk, t, k, n):
    """(KP / 16, NP / BN, T, BN, 16) -> (T, K, N) float32, checking that
    everything past K and N is zero."""
    a = wk.float().numpy()
    chunks, tiles, taps, bn, kc = a.shape
    assert taps == t and kc == 16 and bn % 8 == 0
    a = a.reshape(chunks, tiles, taps, bn // 8, 2, 4, 2, 8).copy()
    a[:, :, :, :, 1] = a[:, :, :, :, 1, :, ::-1]           # halves back where n & 4
    a = a.reshape(chunks, tiles, taps, bn, kc)
    full = a.transpose(2, 0, 4, 1, 3).reshape(taps, chunks * kc, tiles * bn)
    assert not full[:, k:, :].any() and not full[:, :, n:].any()
    return full[:, :k, :n]


def _taps(w):
    """OIHW (Cout, Cin, kh, kw) -> (kh * kw, Cin, Cout) in bf16, as float."""
    cout, cin, kh, kw = w.shape
    return w.to(torch.bfloat16).float().permute(2, 3, 1, 0).reshape(
        kh * kw, cin, cout).numpy()


@pytest.mark.parametrize("t,k,n,bn", [(9, 128, 528, 136), (9, 40, 24, 32),
                                      (1, 144, 64, 64), (9, 13, 130, 128)])
def test_pack_kmajor_unpacks_to_its_taps(t, k, n, bn):
    taps = _t(np.random.default_rng(0), (t, k, n))
    wk = ce.pack_kmajor(taps, bn)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous()
    assert tuple(wk.shape) == (-(-k // 16), -(-n // bn), t, bn, 16)
    np.testing.assert_array_equal(_unpack(wk, t, k, n),
                                  taps.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("cin,cout,h,w", [(128, 528, 128, 96), (128, 256, 128, 96),
                                          (256, 256, 128, 96), (128, 128, 256, 192),
                                          (64, 33, 37, 45)])
def test_wide_weights_unpack_to_oihw(cin, cout, h, w):
    rng = np.random.default_rng(1)
    wt, bias = _t(rng, (cout, cin, 3, 3)), _t(rng, (cout,))
    bn = tc3.wide_bn((4, h, w, cin), cout)
    wk, bk = tc3.wide_weights(wt, bias, bn)
    assert wk.shape[3] == bn and bk.dtype == torch.float32
    np.testing.assert_array_equal(_unpack(wk, 9, cin, cout), _taps(wt))
    want = np.zeros(wk.shape[1] * bn, np.float32)
    want[:cout] = bias.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bk.numpy(), want)


def test_wide_tiles_fill_the_card():
    """The N tiles the wide kernel takes at the main path's sites (132 SMs):
    528 columns over 192 pixel blocks are four tiles of 136."""
    assert ce.sm_count() == 132                       # no card here
    assert tc3.wide_bn((4, 128, 96, 128), 528) == 136
    assert tc3.wide_bn((4, 128, 96, 128), 256) == 128
    assert tc3.wide_bn((4, 128, 96, 256), 256) == 128
    assert tc3.wide_bn((4, 256, 192, 128), 128) == 128


@pytest.mark.parametrize("c", [144, 80, 64, 32, 40, 272, 128])
def test_gamma_beta_packing_interleaves_groups_of_eight(c):
    """Stage (a)'s operand: N tile j, group i of 16 columns = gamma of the
    channels j CT + 8 i .. + 7, then beta of the same; zero columns past C."""
    rng = np.random.default_rng(2)
    nh = 128
    wg, wb = _t(rng, (c, nh, 3, 3)), _t(rng, (c, nh, 3, 3))
    ct, nt = tsb.gb_tiles(c)
    assert 2 * ct in tsf._GB_BN and ct % 8 == 0 and ct * nt >= c
    cols = _unpack(tsb.pack_gb(wg, wb, ct, nt), 9, nh, nt * 2 * ct)
    tg, tb = _taps(wg), _taps(wb)
    for j in range(nt):
        for i in range(ct // 8):
            for e in range(8):
                ch = j * ct + 8 * i + e
                col = j * 2 * ct + 16 * i + e
                if ch < c:
                    np.testing.assert_array_equal(cols[:, :, col], tg[:, :, ch])
                    np.testing.assert_array_equal(cols[:, :, col + 8], tb[:, :, ch])
                else:
                    assert not cols[:, :, col].any() and not cols[:, :, col + 8].any()


def test_unit_tiles():
    """Stage (a)'s tiles, the unit's and the modulation's (one rule): the
    fewest tiles of at most 96 columns, each the narrowest that holds its
    share; 272 and 128 are the modulation's C at up_2."""
    assert tsb.gb_tiles is tsf.gb_tiles
    assert [tsb.gb_tiles(c) for c in (144, 80, 64, 32, 40, 24, 272, 128)] == \
        [(48, 3), (40, 2), (32, 2), (32, 1), (40, 1), (32, 1), (48, 6), (48, 3)]
    assert [tsb.conv_tiles(c) for c in (64, 32, 24, 130)] == \
        [(64, 1), (32, 1), (32, 1), (128, 2)]


@pytest.mark.parametrize("c,cout,ks", [(144, 64, 1), (144, 64, 3), (80, 32, 3),
                                       (32, 32, 3), (40, 24, 1)])
def test_unit_stage_weights_unpack(c, cout, ks):
    rng = np.random.default_rng(3)
    wg, wb = _t(rng, (c, 128, 3, 3)), _t(rng, (c, 128, 3, 3))
    bg, bb = _t(rng, (c,)), _t(rng, (c,))
    wc, bc = _t(rng, (cout, c, ks, ks)), _t(rng, (cout,))
    (wk_gb, bgb, ct, ntg), (wk_c, bk, bn, ntc) = tsb._stage_weights(
        wg, bg, wb, bb, wc, bc, c, cout, ks)
    assert (ct, ntg) == tsb.gb_tiles(c) and (bn, ntc) == tsb.conv_tiles(cout)
    np.testing.assert_array_equal(
        bgb.numpy(), torch.stack([bg, bb]).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(_unpack(wk_c, ks * ks, c, cout), _taps(wc))
    want = np.zeros(ntc * bn, np.float32)
    want[:cout] = bc.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bk.numpy(), want)


@pytest.mark.parametrize("c", [272, 128, 144, 64, 80, 32])
def test_gamma_beta_stage_is_the_modulation(c):
    """The bf16 modulation runs as the unit's gamma|beta stage with no
    activation: with the statistics that ``modulate_ref`` forms, the
    stage's plain version gives ``modulate_ref`` bit for bit at the nine
    norms' C."""
    rng = np.random.default_rng(8)
    b, h, w, nh = 2, 6, 5, 16
    args = [_t(rng, (b, h, w, c)).bfloat16(), _t(rng, (b, h, w, 1)), _t(rng, (c,), 0.3),
            _t(rng, (b, h, w, nh)).bfloat16(), _t(rng, (c, nh, 3, 3), 0.1),
            _t(rng, (c,), 0.1), _t(rng, (c, nh, 3, 3), 0.1), _t(rng, (c,), 0.1)]
    want = tsf.modulate_ref(*args)
    mu, rsig = _stats_two_pass(*args[:3])
    got = tsb.gamma_beta_stage_ref(*args[:3], mu, rsig, *args[3:], pre_act=None)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_gamma_beta_weights_packed_once():
    """The modulation's and the unit's stage (a) operands: packed once per
    weight set, again after an in-place update."""
    rng = np.random.default_rng(9)
    wg, wb = _t(rng, (128, 128, 3, 3)), _t(rng, (128, 128, 3, 3))
    bg, bb = _t(rng, (128,)), _t(rng, (128,))
    wk, bgb, ct, nt = tsf.gb_weights(wg, bg, wb, bb)
    assert (ct, nt) == (48, 3)
    again = tsf.gb_weights(wg, bg, wb, bb)
    assert again[0] is wk and again[1] is bgb
    bb.mul_(3.0)
    wk2, bgb2, _, _ = tsf.gb_weights(wg, bg, wb, bb)
    assert bgb2 is not bgb
    np.testing.assert_array_equal(
        bgb2.numpy(), torch.stack([bg, bb]).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(wk2.float().numpy(),
                                  tsf.pack_gb(wg, wb, ct, nt).float().numpy())


@pytest.mark.parametrize("cin,cout", [(9, 16), (32, 32), (32, 3), (7, 42), (16, 8),
                                      (20, 24)])
def test_small_weights_unpack_to_oihw(cin, cout):
    """The small kernel's operand: N tiles of 8, 16 or 32 (Cout = 3: one of
    8; 42: two of 32), Cin zero-padded to 16 (a narrow input's spread leaves
    channels Cin..15 zero: the products see zeros times zeros; Cin = 20 is
    read from x padded to 24, whose two K chunks these weights fill)."""
    rng = np.random.default_rng(10)
    wt, bias = _t(rng, (cout, cin, 3, 3)), _t(rng, (cout,))
    bn, nt = tc3.small_tiles(cout)
    assert bn in tc3._SMALL_BN and bn * nt >= cout and (nt == 1 or bn == 32)
    wk, bk = tc3.small_weights(wt, bias, bn)
    assert tuple(wk.shape) == (-(-cin // 16), nt, 9, bn, 16)
    np.testing.assert_array_equal(_unpack(wk, 9, cin, cout), _taps(wt))
    want = np.zeros(nt * bn, np.float32)
    want[:cout] = bias.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bk.numpy(), want)
    assert tc3.small_tiles(3) == (8, 1) and tc3.small_tiles(16) == (16, 1)


def test_small_weights_cache_follows_in_place_updates():
    rng = np.random.default_rng(11)
    w, b = _t(rng, (16, 9, 3, 3)), _t(rng, (16,))
    wk, bk = tc3.small_weights(w, b, 16)
    assert tc3.small_weights(w, b, 16)[0] is wk           # packed once
    w.add_(1.0)
    wk2, bk2 = tc3.small_weights(w, b, 16)
    assert wk2 is not wk and bk2 is not bk
    np.testing.assert_array_equal(_unpack(wk2, 9, 9, 16), _taps(w))
    b.mul_(-2.0)
    np.testing.assert_array_equal(tc3.small_weights(w, b, 16)[1].numpy()[:16],
                                  b.to(torch.bfloat16).float().numpy())


def test_narrow_box():
    """Two boxes of ``narrow_box(C)`` elements hold a halo row of 34 pixels
    from the 16 bytes at or left of its first element; each a multiple of 8
    elements, at most 256. Not for Cin that a 4-D box takes, nor above 14."""
    assert tc3.narrow_box(9) == 160
    for c in (1, 2, 3, 5, 7, 9, 11, 13, 14):
        e = tc3.narrow_box(c)
        assert e % 8 == 0 and 0 < e <= 256 and 2 * e >= 34 * c + 7
        assert 2 * (e - 8) < 34 * c + 7                  # the least such
    for c in (0, 8, 15, 16, 24):
        with pytest.raises(ValueError):
            tc3.narrow_box(c)


def test_small_channels():
    """The channels the small bf16 kernel reads: Cin as it is where a 4-D box
    (a multiple of 8) or a narrow stage (below 15) takes it, else padded to
    the next multiple of 8, which keeps the weights' K chunks of 16."""
    for cin in range(1, 43):
        k = tc3.small_channels(cin)
        if cin % 8 == 0 or cin < 15:
            assert k == cin
        else:
            assert k % 8 == 0 and cin < k < cin + 8
            assert -(-k // 16) == -(-cin // 16)
    assert [tc3.small_channels(c) for c in (9, 15, 20, 32, 33, 42)] == [9, 16, 24, 32, 40, 48]


@pytest.mark.parametrize("cin,w", [(9, 40), (9, 384), (7, 72), (13, 8), (3, 40)])
def test_narrow_rows_spread_to_the_halo(cin, w):
    """The narrow input's layout arithmetic as the engine's producer and its
    spread pass do it (csrc/conv_engine.cuh: boxes from the halo's first
    element rounded down to 16 bytes, a second box only where the row
    reaches into it, elements right of the row zeroed, left of it the box's
    zero fill), emulated in numpy on one image row: every column strip's 34
    halo pixels come out as the row with its zero border."""
    rng = np.random.default_rng(12)
    row = rng.standard_normal(w * cin).astype(np.float32)
    e_box = tc3.narrow_box(cin)

    def box(start):                     # a box of the 3-D map, zero-filled outside
        out = np.zeros(e_box, np.float32)
        lo, hi = max(start, 0), min(start + e_box, w * cin)
        if hi > lo:
            out[lo - start:hi - start] = row[lo:hi]
        return out
    padded = np.concatenate([np.zeros(cin), row, np.zeros(40 * cin)]).reshape(-1, cin)
    for x0 in range(0, w, 32):
        e = (x0 - 1) * cin
        e0 = e & ~7
        two = e0 + e_box < w * cin
        raw = np.concatenate([box(e0), box(e0 + e_box) if two else
                              np.full(e_box, np.nan, np.float32)])
        d, lim = e - e0, w * cin - e0
        halo = np.zeros((34, 16), np.float32)
        for col in range(34):
            for c in range(cin):
                el = d + col * cin + c
                halo[col, c] = 0.0 if el >= lim else raw[el]
        np.testing.assert_array_equal(halo[:, :cin], padded[x0:x0 + 34])
        assert not halo[:, cin:].any()


def test_packing_cache_follows_in_place_updates():
    rng = np.random.default_rng(4)
    w, b = _t(rng, (72, 128, 3, 3)), _t(rng, (72,))
    wk, bk = tc3.wide_weights(w, b, 64)
    again = tc3.wide_weights(w, b, 64)
    assert again[0] is wk and again[1] is bk              # packed once
    assert tc3.wide_weights(w, b, 32)[0] is not wk        # another N tile
    w.mul_(2.0)                                           # in place: re-pack
    wk2, _ = tc3.wide_weights(w, b, 64)
    assert wk2 is not wk
    np.testing.assert_array_equal(_unpack(wk2, 9, 128, 72), _taps(w))
    b.add_(1.0)
    bk3 = tc3.wide_weights(w, b, 64)[1]
    np.testing.assert_array_equal(bk3.numpy()[:72],
                                  b.to(torch.bfloat16).float().numpy())
    w2 = w.clone()                                        # same values, new tensor
    assert tc3.wide_weights(w2, b, 64)[0] is not wk2
    with torch.inference_mode():
        wi = w.clone()                                    # no version counter
        assert ce.packed("t", (wi,), lambda: object()) is not \
            ce.packed("t", (wi,), lambda: object())


def test_packing_cache_drops_dead_tensors():
    """A tensor that died cannot be matched by a new one at its address."""
    calls = []

    def make():
        calls.append(1)
        return len(calls)
    for _ in range(3):
        t = torch.zeros(8)
        ce.packed("dead", (t,), make)
        del t
    assert len(calls) == 3


def _stats_two_pass(x, noise, nscale):
    """mu, rsig as ``modulate_ref`` forms them inside (two passes, f32)."""
    xnf = (x + (noise * nscale).to(x.dtype)).float()
    mu = xnf.mean(dim=(1, 2))
    var = (xnf - mu[:, None, None, :]).square().mean(dim=(1, 2))
    return mu, torch.rsqrt(var + 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ks,pre_act,residual", [(3, "leaky0.2", True),
                                                 (1, None, False),
                                                 (3, "relu", False)])
def test_two_stages_give_spade_conv_ref(dtype, ks, pre_act, residual):
    rng = np.random.default_rng(5)
    b, h, w, c, cout, nh = 2, 12, 10, 24, 16, 32
    args = [_t(rng, (b, h, w, c)).to(dtype), _t(rng, (b, h, w, 1)),
            _t(rng, (c,), 0.3), _t(rng, (b, h, w, nh)).to(dtype),
            _t(rng, (c, nh, 3, 3), 0.1), _t(rng, (c,), 0.1),
            _t(rng, (c, nh, 3, 3), 0.1), _t(rng, (c,), 0.1),
            _t(rng, (cout, c, ks, ks), 0.2), _t(rng, (cout,), 0.1)]
    res = _t(rng, (b, h, w, cout)).to(dtype) if residual else None
    want = tsb.spade_conv_ref(*args, pre_act=pre_act, residual=res)
    mu, rsig = _stats_two_pass(*args[:3])
    mod = tsb.gamma_beta_stage_ref(*args[:3], mu, rsig, *args[3:8],
                                   pre_act=pre_act)
    got = tsb.consumer_stage_ref(mod, args[8], args[9], res)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_norm_stats_on_cpu_is_instance_stats():
    rng = np.random.default_rng(6)
    x, noise, nscale = _t(rng, (2, 9, 11, 13)), _t(rng, (2, 9, 11, 1)), _t(rng, (13,))
    before = tsf.norm_stats.launches
    got = tsf.norm_stats(x, noise, nscale)
    want = tsf.instance_stats(x, noise, nscale)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert tsf.norm_stats.launches == before             # no kernel on the CPU


def test_tools_pack_weights_kmajor_is_the_engines():
    """The conv experiments' K-major packing is the engine's with N tiles of
    128 (``tools`` re-imports it from ``ops``)."""
    from hrviton_tpu_torch.tools import _common
    w = _t(np.random.default_rng(7), (3, 3, 40, 130))
    assert _common.pack_weights_kmajor is ce.pack_weights_kmajor
    np.testing.assert_array_equal(
        ce.pack_weights_kmajor(w).float().numpy(),
        ce.pack_kmajor(w.reshape(9, 40, 130), 128).float().numpy())
