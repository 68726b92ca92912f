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


@pytest.mark.parametrize("c", [144, 80, 64, 32, 40])
def test_gamma_beta_packing_interleaves_groups_of_eight(c):
    """Stage (a)'s operand: N tile j, group i of 16 columns = gamma of the
    channels j CT + 8 i .. + 7, then beta of the same; zero columns past C."""
    rng = np.random.default_rng(2)
    nh = 128
    wg, wb = _t(rng, (c, nh, 3, 3)), _t(rng, (c, nh, 3, 3))
    ct, nt = tsb.gb_tiles(c)
    assert 2 * ct in tsb._GB_BN and ct % 8 == 0 and ct * nt >= c
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
    assert [tsb.gb_tiles(c) for c in (144, 80, 64, 32, 40, 24)] == \
        [(48, 3), (40, 2), (32, 2), (32, 1), (40, 1), (32, 1)]
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
    assert tsf.stats_bytes(2, 9, 11, 13) == 2 * 99 * (13 * 2 + 4) + 2 * 2 * 13 * 4


def test_tools_pack_weights_kmajor_is_the_engines():
    """The conv experiments' K-major packing is the engine's with N tiles of
    128 (``tools`` re-imports it from ``ops``)."""
    from hrviton_tpu_torch.tools import _common
    w = _t(np.random.default_rng(7), (3, 3, 40, 130))
    assert _common.pack_weights_kmajor is ce.pack_weights_kmajor
    np.testing.assert_array_equal(
        ce.pack_weights_kmajor(w).float().numpy(),
        ce.pack_kmajor(w.reshape(9, 40, 130), 128).float().numpy())
