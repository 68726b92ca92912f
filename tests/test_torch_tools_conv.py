"""The conv-experiment path: the port's ``hrviton_tpu_torch/tools`` (plain
versions on the CPU) vs the JAX scripts under ``tools/`` with their Pallas
kernels in interpret mode, on the same numpy inputs, in f32 and bf16; and
vs the library conv. The CUDA kernels themselves are held against these
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: f32, 1e-5 x max|ref| (sums of 9 * Cin f32 products in another
order); bf16, one bf16 ulp of max|ref| (2^-7 x max|ref|: both sides
accumulate in f32 and round once, so they differ by single roundings). The
probe is a copy: bit for bit. The edge cases of the shift formulations (the
tightest padded width, one and two bands, corner impulses) hold the plain
versions to the library conv in f32.

The JAX scripts are loaded by file path (importing one runs no ``main``).
``exp_pallas_conv2`` reads its ``INTERPRET`` switch at call time; the other
two pass no such flag, so ``pallas_call`` is patched for them.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu_torch.tools import _common, exp_conv, exp_conv2, exp_copy_probe

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

# (batch, h, w, cin, cout, th)
SIZES = [(1, 32, 24, 8, 16, 8), (2, 32, 24, 8, 16, 16)]
DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]


@functools.lru_cache(maxsize=None)
def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(monkeypatch, mod):
    """Make the script's ``pl.pallas_call`` run in interpret mode."""
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))


def _inputs(size, seed=0):
    b, h, w, cin, cout, _ = size
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_close(got, want, tdtype):
    """got: torch tensor; want: float32 numpy."""
    scale = np.abs(want).max()
    tol = (1e-5 if tdtype == torch.float32 else 2.0 ** -7) * scale
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol, (err, tol)


def _conv_case(port_fn, port_ref, jax_fn, size, tdtype, jdtype):
    xn, wn = _inputs(size)
    th = size[-1]
    x, w = torch.from_numpy(xn).to(tdtype), torch.from_numpy(wn).to(tdtype)
    before = port_fn.launches
    got = port_fn(x, w, th=th)                  # a CPU tensor: the plain version
    assert port_fn.launches == before
    assert got.dtype == tdtype and tuple(got.shape) == size[:3] + (size[4],)
    assert torch.equal(got, port_ref(x, w, th))
    want = _f32(jax_fn(jnp.asarray(xn, jdtype), jnp.asarray(wn, jdtype), th=th))
    _assert_close(got, want, tdtype)
    _assert_close(got, _common.conv_ref(x, w).float().numpy(), tdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("size", SIZES, ids=["one_image_th8", "two_images_th16"])
def test_conv_halo_matches_jax(monkeypatch, size, name, tdtype, jdtype):
    tool = _jax_tool("exp_pallas_conv2")
    monkeypatch.setattr(tool, "INTERPRET", True)
    _conv_case(exp_conv2.conv_halo, exp_conv2.conv_halo_ref, tool.conv_halo,
               size, tdtype, jdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("size", SIZES, ids=["one_image_th8", "two_images_th16"])
def test_conv_dma_matches_jax(monkeypatch, size, name, tdtype, jdtype):
    tool = _jax_tool("exp_pallas_conv2")
    monkeypatch.setattr(tool, "INTERPRET", True)
    _conv_case(exp_conv2.conv_dma, exp_conv2.conv_dma_ref, tool.conv_dma,
               size, tdtype, jdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("size", SIZES, ids=["one_image_th8", "two_images_th16"])
def test_conv_roll_matches_jax(monkeypatch, size, name, tdtype, jdtype):
    tool = _jax_tool("exp_pallas_conv2")
    monkeypatch.setattr(tool, "INTERPRET", True)
    _conv_case(exp_conv2.conv_roll, exp_conv2.conv_roll_ref, tool.conv_roll,
               size, tdtype, jdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("size", SIZES, ids=["one_image_th8", "two_images_th16"])
def test_conv_prodroll_matches_jax(monkeypatch, size, name, tdtype, jdtype):
    tool = _jax_tool("exp_pallas_conv2")
    monkeypatch.setattr(tool, "INTERPRET", True)
    _conv_case(exp_conv2.conv_prodroll, exp_conv2.conv_prodroll_ref, tool.conv_prodroll,
               size, tdtype, jdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("size", SIZES, ids=["one_image_th8", "two_images_th16"])
def test_conv_e_matches_jax(monkeypatch, size, name, tdtype, jdtype):
    tool = _jax_tool("exp_pallas_conv2")
    monkeypatch.setattr(tool, "INTERPRET", True)
    _conv_case(exp_conv2.conv_e, exp_conv2.conv_e_ref, tool.conv_e,
               size, tdtype, jdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("size", SIZES, ids=["one_image_th8", "two_images_th16"])
def test_conv_e2_matches_jax(monkeypatch, size, name, tdtype, jdtype):
    tool = _jax_tool("exp_pallas_conv2")
    monkeypatch.setattr(tool, "INTERPRET", True)
    _conv_case(exp_conv2.conv_e2, exp_conv2.conv_e2_ref, tool.conv_e2,
               size, tdtype, jdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("size", SIZES, ids=["one_image_th8", "two_images_th16"])
def test_conv_band_matches_jax(monkeypatch, size, name, tdtype, jdtype):
    tool = _jax_tool("exp_pallas_conv")
    _interpret(monkeypatch, tool)
    _conv_case(exp_conv.conv_band, exp_conv.conv_band_ref, tool.conv_pallas,
               size, tdtype, jdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("size", SIZES, ids=["one_image_th8", "two_images_th16"])
def test_probe_matches_jax(monkeypatch, size, name, tdtype, jdtype):
    tool = _jax_tool("exp_dma_probe")
    _interpret(monkeypatch, tool)
    th = size[-1]
    monkeypatch.setattr(tool, "TH", th)
    xn, _ = _inputs(size)
    x = torch.from_numpy(xn).to(tdtype)
    before = exp_copy_probe.probe.launches
    got = exp_copy_probe.probe(x, th=th)
    assert exp_copy_probe.probe.launches == before
    assert torch.equal(got, x)
    assert torch.equal(exp_copy_probe.probe_ref(x, th), x)
    want = _f32(tool.probe(jnp.asarray(xn, jdtype)))
    assert np.array_equal(got.float().numpy(), want)


def test_halo_tiles_match_jax_gather():
    """Tile i is padded rows [i * th, i * th + th + 2), Wp = W + 2 up to 8."""
    size = (2, 32, 20, 8, 16, 8)
    xn, _ = _inputs(size)
    th = size[-1]
    tiles = exp_conv2.halo_tiles(torch.from_numpy(xn), th)
    wp = -(-(20 + 2) // 8) * 8
    xp = np.pad(xn, ((0, 0), (1, 1), (1, wp - 20 - 1), (0, 0)))
    idx = (np.arange(32 // th) * th)[:, None] + np.arange(th + 2)[None, :]
    assert tuple(tiles.shape) == (2, 4, th + 2, wp, 8)
    assert np.array_equal(tiles.numpy(), xp[:, idx])
    assert np.array_equal(_common.pad_input(torch.from_numpy(xn)).numpy(), xp)


_SHIFT = {"roll": (exp_conv2.conv_roll, exp_conv2.conv_roll_ref),
          "prodroll": (exp_conv2.conv_prodroll, exp_conv2.conv_prodroll_ref),
          "e": (exp_conv2.conv_e, exp_conv2.conv_e_ref),
          "e2": (exp_conv2.conv_e2, exp_conv2.conv_e2_ref)}


def _plain_vs_library(name, size, x=None):
    """Both the wrapper (a CPU tensor: the plain version) and the plain
    version itself against the library conv, in f32."""
    xn, wn = _inputs(size)
    x = torch.from_numpy(xn) if x is None else x
    w = torch.from_numpy(wn)
    want = _common.conv_ref(x, w)
    for fn in _SHIFT[name]:
        got = fn(x, w, th=size[-1])
        assert tuple(got.shape) == tuple(want.shape)
        _assert_close(got, want.numpy(), torch.float32)
    return got, want


@pytest.mark.parametrize("name", ["roll", "prodroll"])
def test_circular_roll_is_harmless_at_the_tightest_width(name):
    """W % 8 == 6: Wp = W + 2, no spare padded column. The roll wraps padded
    column 0 onto Wp - 1 and back; no kept column may see it."""
    size = (2, 16, 22, 8, 16, 8)
    assert _common.pad_input(torch.zeros(size[:4])).shape[2] == size[2] + 2
    _plain_vs_library(name, size)


@pytest.mark.parametrize("bands", [1, 2], ids=["one_band", "two_bands"])
@pytest.mark.parametrize("name", ["e", "e2"])
def test_band_cases_of_the_unpadded_copy(name, bands):
    """Two bands: a first and a last, no middle one. One band (H == th) is
    first and last at once: both missing rows are zero."""
    th = 8
    size = (2, bands * th, 24, 8, 16, th)
    tiles = exp_conv2.band_tiles(torch.from_numpy(_inputs(size)[0]), th)
    assert tuple(tiles.shape) == (2, bands, th + 2, 24, 8)
    assert not tiles[:, 0, 0].any() and not tiles[:, -1, -1].any()
    assert tiles[:, 0, 1].any() and tiles[:, -1, -2].any()
    _plain_vs_library(name, size)


@pytest.mark.parametrize("name", sorted(_SHIFT))
def test_corner_impulses(name):
    """An impulse in each image corner: a shift that wrapped, or a border
    column that was not masked, would put a corner's taps on the other side;
    each corner reaches exactly its 2 x 2 neighbourhood."""
    size = (1, 16, 22, 8, 16, 8)
    x = torch.zeros(size[:4])
    for r in (0, -1):
        for c in (0, -1):
            x[:, r, c] = 1.0
    got, want = _plain_vs_library(name, size, x)
    reached = torch.zeros(size[1:3], dtype=torch.bool)
    for r in (slice(0, 2), slice(-2, None)):
        for c in (slice(0, 2), slice(-2, None)):
            reached[r, c] = True
    assert not got[0, ~reached].any() and got[0, reached].any()
    assert torch.equal(got == 0, want == 0)


def test_weight_packings_and_product_shift_match_jax(monkeypatch):
    tool = _jax_tool("exp_pallas_conv2")
    monkeypatch.setattr(tool, "INTERPRET", True)
    wn = _inputs(SIZES[0])[1]
    w = torch.from_numpy(wn)
    assert _common.pack_taps(w) is w
    assert np.array_equal(_common.pack_kx(w).numpy(), np.concatenate(
        [wn[:, 2], wn[:, 1], wn[:, 0]], axis=1))
    assert np.array_equal(_common.pack_ky(w).numpy(), np.stack(
        [np.concatenate([wn[0, kx], wn[1, kx], wn[2, kx]], axis=0)
         for kx in range(3)]))
    p = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3) + 1
    col = np.arange(5).reshape(1, 5, 1)
    for kx in range(3):
        want = np.asarray(tool._roll_p(jnp.asarray(p), kx, 5, col))
        assert np.array_equal(_common.roll_p(torch.from_numpy(p), kx).numpy(), want)


def _unswizzled(wk):
    """Undo the 32-byte swizzle of ``pack_weights_kmajor`` in numpy: the two
    16-byte halves of row n change places where n & 4. Returns f32."""
    a = wk.float().numpy().copy()
    rows = (np.arange(a.shape[3]) & 4) != 0
    a[:, :, :, rows] = np.concatenate([a[:, :, :, rows, 8:],
                                       a[:, :, :, rows, :8]], axis=-1)
    return a


@pytest.mark.parametrize("bn,kpad", [(128, 16), (64, 32)],
                         ids=["halo_roll_layout", "shift_layout"])
@pytest.mark.parametrize("pack", [_common.pack_taps, _common.pack_kx,
                                  _common.pack_ky], ids=["taps", "kx", "ky"])
@pytest.mark.parametrize("cin,cout", [(8, 16), (40, 130), (128, 128)],
                         ids=["8to16", "40to130", "128to128"])
def test_kmajor_weight_packing(pack, cin, cout, bn, kpad):
    """[chunk][tile][slice][n][k] of the K-major packing is element [slice][16
    chunk + k][bn tile + n] of the (9, Cin, Cout) packing the other kernels
    read, zeros in the padding, bf16, contiguous; N tiles of 128 and Cin
    padded to 16 (conv_halo, conv_roll), or 64 and 32 (conv_prodroll with the
    taps, conv_e2 with pack_ky: two chunks a stage)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout))
                         .astype(np.float32))
    wk = _common.pack_weights_kmajor(w, pack, bn=bn, kpad=kpad)
    nch, nt = -(-cin // kpad) * kpad // 16, -(-cout // bn)
    assert tuple(wk.shape) == (nch, nt, 9, bn, 16)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous()
    want = np.zeros((9, nch * 16, nt * bn), np.float32)
    want[:, :cin, :cout] = pack(w.to(torch.bfloat16)).reshape(9, cin, cout) \
        .float().numpy()
    want = want.reshape(9, nch, 16, nt, bn).transpose(1, 3, 0, 4, 2)
    assert np.array_equal(_unswizzled(wk), want)


@pytest.mark.parametrize("entry,th", [("conv_halo_forward_bf16", 8),
                                      ("conv_roll_forward_bf16", 16),
                                      ("conv_e_forward_bf16", 8),
                                      ("conv_prodroll_forward_bf16", 16),
                                      ("conv_e2_forward_bf16", 8),
                                      ("conv_band_forward_bf16", 8),
                                      ("conv_dma_forward_bf16", 16)])
def test_unstaged_kernels_need_16_byte_pixels(entry, th):
    """A kernel that reads x as it is needs Cin % 8 == 0; the launcher says
    so before it builds or launches anything (here on a CPU tensor)."""
    x = torch.zeros(1, 16, 16, 12, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 12, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        _common.run_conv_exp(entry, x, w, th)


@pytest.mark.parametrize("entry,source,ths", [
    ("conv_halo_forward_bf16", "conv_tma", (8, 16, 32)),
    ("conv_roll_forward_bf16", "conv_tma", (8, 16)),
    ("conv_band_forward_bf16", "conv_tma", (8, 16, 32)),
    ("conv_dma_forward_bf16", "conv_tma", (8, 16, 32)),
    ("conv_prodroll_forward_bf16", "conv_tma", (8, 16)),
    ("conv_e_forward_bf16", "conv_tma", (8, 16)),
    ("conv_e2_forward_bf16", "conv_tma", (8, 16))])
def test_band_heights_are_looked_up_per_entry(entry, source, ths):
    x = torch.zeros(1, 96, 16, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16)
    assert _common._ENTRIES[entry][:2] == (source, ths)
    for th in {8, 16, 24, 32} - set(ths):
        with pytest.raises(ValueError, match="built for th"):
            _common.run_conv_exp(entry, x, w, th)
    with pytest.raises(TypeError, match="bfloat16"):
        _common.run_conv_exp(entry, x.float(), w, ths[0])


@pytest.mark.parametrize("entry", ["conv_halo_forward_bf16",
                                   "conv_roll_forward_bf16",
                                   "conv_e_forward_bf16"])
def test_only_the_band_kind_has_cluster_variants(entry):
    """The cluster variants are conv_band's and conv_dma's; the launcher
    refuses a cluster for any other kernel before it builds anything."""
    x = torch.zeros(1, 16, 16, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no cluster variants"):
        _common.conv_launcher(entry, x, w, 8, cluster=2)


def _strip_products(kind, x, w):
    """What the kernels of ``csrc/conv_tma.cu`` behind conv_prodroll and
    conv_e2 compute, as they index their operands, in f32: the weights as
    their wrapper packs them (K-major, N tiles of 64, unswizzled here), strips
    of 64 product columns (image columns x0 - 1 .. x0 + 62, zeros outside the
    image) at x0 = 62 s, three accumulators acc[kx] = sum over ky and chunks
    of the rows ky - 1 away times slice 3 ky + kx (prodroll, taps) or 3 kx +
    ky (e2, ``pack_ky``), then o[m] = acc0[m - 1] + acc1[m] + acc2[m + 1]
    kept for m = 1 .. 62 inside the image."""
    pack, entry = ((_common.pack_taps, "conv_prodroll_forward_bf16")
                   if kind == "prodroll" else
                   (_common.pack_ky, "conv_e2_forward_bf16"))
    wk = torch.from_numpy(_unswizzled(_common._ENTRIES[entry][2](w, pack)))
    nch, nt, _, bn, kc = wk.shape
    taps = wk.permute(2, 0, 4, 1, 3).reshape(9, nch * kc, nt * bn)
    b, h, ww, c = x.shape
    strips = -(-ww // 62)
    xp = torch.zeros(b, h + 2, 62 * strips + 2, nch * kc)
    xp[:, 1:h + 1, 1:ww + 1, :c] = x.float()
    out = torch.zeros(b, h, 62 * strips, nt * bn)
    for s in range(strips):
        x0 = 62 * s
        acc = [0.0, 0.0, 0.0]
        for ky in range(3):
            rows = xp[:, ky:ky + h, x0:x0 + 64]
            for kx in range(3):
                acc[kx] = acc[kx] + rows @ taps[3 * ky + kx if kind == "prodroll"
                                                else 3 * kx + ky]
        out[:, :, x0:x0 + 62] = acc[0][:, :, 0:62] + acc[1][:, :, 1:63] \
            + acc[2][:, :, 2:64]
    return out[:, :, :ww, :w.shape[-1]]


@pytest.mark.parametrize("ww", [5, 62, 63, 130])
@pytest.mark.parametrize("kind", ["prodroll", "e2"])
def test_product_shift_strips_match_the_conv(kind, ww):
    """The strips of conv_prodroll's and conv_e2's kernels, their packed
    weights and the slice each product reads give the library conv (f32):
    W below one strip, exactly one, one column into the second, and two
    strips and a ragged third; Cin = 24 (the second chunk half zero), Cout =
    72 (two N tiles of 64, the second ragged)."""
    size = (2, 4, ww, 24, 72, 4)
    xn, wn = _inputs(size)
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    got = _strip_products(kind, x, w)
    want = _common.conv_ref(x, w.to(torch.bfloat16).float())
    _assert_close(got, want.numpy(), torch.float32)


def _row_walk_products(x, w):
    """What the kernel of ``csrc/conv_tma.cu`` behind conv_e (kind E)
    computes, as it indexes its operands, in f32: the weights as its wrapper
    packs them (K-major, N tiles of 64, unswizzled here); each row walked in
    tiles of 64 product columns at x0 = 64 t (image columns x0 .. x0 + 63,
    no halo column; rows outside the image zero, columns past W filled with
    noise here, so that only the masks and the stores' bounds keep them
    out); three accumulators acc[kx] = sum over ky and chunks of the rows ky
    - 1 away times slice 3 ky + kx; in each tile o[m] = acc0[m - 1] + acc1[m]
    + acc2[m + 1], acc0[-1] the previous tile's p0[63] (none into image
    column 0), acc2's term dropped at image column W - 1; o[0 .. 62] stored,
    o[63] less its p2 term carried to the next tile, which adds its p2[0]
    and stores column x0 - 1, or stored by the row's last tile as it is.
    Every output column is stored exactly once."""
    wk = torch.from_numpy(_unswizzled(_common._ENTRIES["conv_e_forward_bf16"][2](
        w, _common.pack_taps)))
    nch, nt, _, bn, kc = wk.shape
    taps = wk.permute(2, 0, 4, 1, 3).reshape(9, nch * kc, nt * bn)
    b, h, ww, c = x.shape
    ntw = -(-ww // 64)
    noise = np.random.default_rng(9).standard_normal((b, h, ntw * 64 - ww, c))
    xp = torch.zeros(b, h + 2, ntw * 64, nch * kc)
    xp[:, 1:h + 1, :ww, :c] = x.float()
    xp[:, 1:h + 1, ww:, :c] = torch.from_numpy(noise.astype(np.float32))
    out = torch.zeros(b, h, ntw * 64, nt * bn)
    stores = torch.zeros(ntw * 64, dtype=torch.int64)
    for t in range(ntw):
        x0 = 64 * t
        acc = [0.0, 0.0, 0.0]
        for ky in range(3):
            rows = xp[:, ky:ky + h, x0:x0 + 64]
            for kx in range(3):
                acc[kx] = acc[kx] + rows @ taps[3 * ky + kx]
        left, right = torch.zeros_like(acc[0]), torch.zeros_like(acc[2])
        left[:, :, 1:] = acc[0][:, :, :-1]
        right[:, :, :-1] = acc[2][:, :, 1:]
        right[:, :, (x0 + torch.arange(64)) == ww - 1] = 0.0
        if x0 > 0:
            left[:, :, 0] = carry
            out[:, :, x0 - 1] = part + acc[2][:, :, 0]
            stores[x0 - 1] += 1
        o = left + acc[1] + right
        out[:, :, x0:x0 + 63] = o[:, :, :63]
        stores[x0:x0 + 63] += 1
        carry, part = acc[0][:, :, 63], o[:, :, 63]
        if x0 + 64 >= ww:                         # the row's last tile
            out[:, :, x0 + 63] = part
            stores[x0 + 63] += 1
    assert torch.equal(stores[:ww], torch.ones(ww, dtype=torch.int64))
    return out[:, :, :ww, :w.shape[-1]]


@pytest.mark.parametrize("ww", [5, 63, 64, 65, 129, 192])
def test_product_shift_row_walk_matches_the_conv(ww):
    """conv_e's row walk, its packed weights, the carry across tiles and the
    masks at columns 0 and W - 1 give the library conv (f32): W below one
    tile, one column short of it, exactly one, one column into the second
    (the last tile holds one column), two and one column, three exactly;
    Cin = 24 (the second chunk half zero), Cout = 72 (two N tiles of 64, the
    second ragged)."""
    size = (2, 4, ww, 24, 72, 4)
    xn, wn = _inputs(size)
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    got = _row_walk_products(x, w)
    want = _common.conv_ref(x, w.to(torch.bfloat16).float())
    _assert_close(got, want.numpy(), torch.float32)


# The BAND kind of csrc/conv_tma.cu (conv_band, conv_dma): a block owns TH
# rows x OC columns x 128 output channels, OC = 32, 16, 8 at TH = 8, 16, 32;
# a stage is 16 input channels, one box of TH + 2 rows x OC + 8 columns and
# the stage's weights as 72 rows of 256 bf16.
_BAND_OC = {8: 32, 16: 16, 32: 8}
_W_ROWS, _W_ROW = 72, 256


def _band_cluster_products(x, w, th, cl):
    """What the BAND kind computes in clusters of ``cl`` blocks, as it
    indexes its operands, in f32: the grid with the strips fastest within an
    N tile, their count padded to a multiple of ``cl``; a cluster's blocks
    (consecutive in the grid) on one N tile; each block's stage weights put
    together from the cluster's slices (rank r loads rows [r 72 / cl, (r + 1)
    72 / cl) into every block), which cover the stage exactly once; the nine
    windows of the box at (x0 - 1, y0 - 1) with tap = 3 ky + kx walked as
    conv_dma's loop does (ky = tap // 3); stores masked past W and Cout."""
    wk = torch.from_numpy(_unswizzled(_common._ENTRIES[
        "conv_band_forward_bf16"][2](w, _common.pack_taps)))
    nch, nt, _, bn, kc = wk.shape
    b, h, ww, c = x.shape
    oc = _BAND_OC[th]
    nstrips = -(-(-(-ww // oc)) // cl) * cl
    xp = torch.zeros(b, h + 2, nstrips * oc + 8, nch * kc)   # the zero fill
    xp[:, 1:h + 1, 1:ww + 1, :c] = x.float()
    out = torch.zeros(b, h, nstrips * oc, nt * bn)
    for first in range(0, nt * nstrips, cl):
        blocks = range(first, first + cl)
        tiles = {bx // nstrips for bx in blocks}
        assert len(tiles) == 1
        tile = tiles.pop()
        slots = []
        for q in range(nch):
            stage = wk[q, tile].reshape(_W_ROWS * _W_ROW)
            slot = torch.full_like(stage, float("nan"))
            hits = torch.zeros(stage.numel(), dtype=torch.int64)
            for rank in range(cl):
                rows = slice(rank * _W_ROWS // cl * _W_ROW,
                             (rank + 1) * _W_ROWS // cl * _W_ROW)
                slot[rows] = stage[rows]
                hits[rows] += 1
            assert torch.equal(hits, torch.ones_like(hits))
            slots.append(slot.reshape(9, bn, kc))
        for bx in blocks:
            x0 = bx % nstrips * oc
            for y0 in range(0, h, th):
                acc = torch.zeros(b, th, oc, bn)
                for q in range(nch):
                    box = xp[:, y0:y0 + th + 2, x0:x0 + oc + 8,
                             q * kc:(q + 1) * kc]
                    for tap in range(9):
                        ky = tap // 3
                        kx = tap - 3 * ky
                        acc += box[:, ky:ky + th, kx:kx + oc] @ slots[q][tap].T
                out[:, y0:y0 + th, x0:x0 + oc,
                    tile * bn:(tile + 1) * bn] = acc
    return out[:, :, :ww, :w.shape[-1]]


@pytest.mark.parametrize("ww,th", [(5, 8), (37, 16), (64, 8), (130, 32)],
                         ids=["w5_th8", "w37_th16", "w64_th8", "w130_th32"])
@pytest.mark.parametrize("cl", [1, 2, 4])
def test_band_cluster_tiles_cover_the_conv(cl, ww, th):
    """The BAND kind's strips, clusters, weight slices and windows give the
    library conv (f32): one strip padded to a whole cluster (W = 5), two
    strips and three (W = 37 at OC = 16), two whole ones, 17 at OC = 8 (an
    odd count, padded to 18 or 20); two bands; Cin = 24 (the second chunk
    half from the bounds), Cout = 136 (two N tiles, the second ragged)."""
    size = (2, 2 * th, ww, 24, 136, th)
    xn, wn = _inputs(size)
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    got = _band_cluster_products(x, w, th, cl)
    want = _common.conv_ref(x, w.to(torch.bfloat16).float())
    _assert_close(got, want.numpy(), torch.float32)


@pytest.mark.parametrize("fn", [exp_conv.conv_band, exp_conv2.conv_halo,
                                exp_conv2.conv_dma, exp_conv.conv_band_ref,
                                exp_conv2.conv_halo_ref, exp_conv2.conv_dma_ref,
                                *(f for pair in _SHIFT.values() for f in pair)],
                         ids=lambda f: f.__name__)
def test_conv_wrappers_reject_bad_shapes(fn):
    x, w = torch.zeros(1, 20, 16, 8), torch.zeros(3, 3, 8, 8)
    with pytest.raises(ValueError):
        fn(x, w, th=8)                                  # 20 % 8 != 0
    with pytest.raises(ValueError):
        fn(torch.zeros(1, 16, 16, 4), w, th=8)          # Cin of x and w differ
    assert tuple(fn(torch.zeros(1, 16, 16, 8), w, th=8).shape) == (1, 16, 16, 8)


@pytest.mark.parametrize("fn", [exp_copy_probe.probe, exp_copy_probe.probe_ref],
                         ids=lambda f: f.__name__)
def test_probe_rejects_bad_shapes(fn):
    with pytest.raises(ValueError):
        fn(torch.zeros(1, 20, 16, 8), th=8)
    with pytest.raises(ValueError):
        fn(torch.zeros(16, 16, 8), th=8)
    x = torch.arange(16 * 4 * 8, dtype=torch.float32).reshape(1, 16, 4, 8)
    assert torch.equal(fn(x, th=16), x)                 # one band: first and last


def test_unknown_selector_raises():
    with pytest.raises(ValueError):
        exp_conv2.main("im2col", device="cpu")


def _tiny(monkeypatch, **extra):
    env = {**dict(PROF_BATCH=1, PROF_H=16, PROF_W=16, PROF_C=8, PROF_ITERS=1),
           **extra}
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


_ALL = ("halo", "roll", "prodroll", "dma", "e", "e2")
# what main times after its checks (the JAX script's lists)
_TIMED = {"halo": {"halo TH=8", "halo gather TH=8"}, "roll": {"roll TH=8"},
          "prodroll": {"prodroll TH=8", "prodroll TH=16"}, "dma": {"dma TH=8"},
          "e": set(), "e2": set()}


def _main_labels(which, skip_check):
    chosen = _ALL if which == "all" else (which,)
    if skip_check:
        return {"library"} | {f"{n} TH={th}" for n in chosen for th in (8, 16)}
    return {"library"}.union(*(_TIMED[n] for n in chosen))


@pytest.mark.parametrize("skip_check", [0, 1])
@pytest.mark.parametrize("which", ["all", *_ALL])
def test_exp_conv2_main_on_cpu(monkeypatch, capsys, which, skip_check):
    _tiny(monkeypatch, SKIP_CHECK=skip_check)
    fns = [getattr(exp_conv2, f"conv_{n}") for n in _ALL]
    before = [f.launches for f in fns]
    times = exp_conv2.main(which, device="cpu")
    assert [f.launches for f in fns] == before
    assert set(times) == _main_labels(which, skip_check)
    assert all(t > 0 for t in times.values())
    out = capsys.readouterr().out
    checked = [line.split(":")[0] for line in out.splitlines()
               if "max|diff|" in line]
    assert checked == ([] if skip_check else
                       list(_ALL if which == "all" else (which,)))


def test_exp_conv_main_on_cpu(monkeypatch, capsys):
    _tiny(monkeypatch, PROF_H=32)
    times = exp_conv.main(device="cpu")
    assert set(times) == {"library", "conv3x3_wide", "band TH=8", "band TH=16",
                          "band TH=32"}
    assert "max|diff|" in capsys.readouterr().out


def test_exp_copy_probe_main_on_cpu(monkeypatch, capsys):
    _tiny(monkeypatch, PROF_TH=8)
    got = exp_copy_probe.main(device="cpu")
    assert got["ms"] > 0 and got["gb_per_s"] > 0
    assert "TH=8" in capsys.readouterr().out


@pytest.mark.parametrize("main", [exp_conv.main, exp_conv2.main,
                                  exp_copy_probe.main],
                         ids=["exp_conv", "exp_conv2", "exp_copy_probe"])
def test_mains_default_to_the_card(monkeypatch, main):
    """Without a card an entry point raises; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _tiny(monkeypatch)
    monkeypatch.setattr("sys.argv", ["prog"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main()


def test_timeit_and_check(capsys):
    x, w = torch.ones(1, 8, 8, 8), torch.ones(3, 3, 8, 8)
    ms = _common.timeit("library", _common.conv_ref, x, w, iters=2)
    assert ms > 0 and "library" in capsys.readouterr().out
    assert _common.check("same", _common.conv_ref, x, w) == 0.0
    with pytest.raises(RuntimeError):
        _common.check("off", lambda a, b: _common.conv_ref(a, b) + 1.0, x, w)
