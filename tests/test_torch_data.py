"""The port's data path against the JAX package's, on the CPU.

One synthetic root written by the JAX package's ``make_synthetic_dataset``
(4 samples at 96x128, train and test) feeds both sides. Everything here is
host-side numpy / PIL or integer and 0/1 arithmetic with the same formulas,
so the comparisons are bit for bit: the parse tables, the agnostic maps,
dataset samples in every mode and format, collated and loaded batches (the
same seeded permutation), the synthetic tree's bytes, and the device
expansion of the compact format in f32 and in bf16 (the bf16 values are the
f32 ones rounded once, on both sides).
"""

import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hrviton_tpu.config import DataConfig as JDataConfig
from hrviton_tpu.core import precision as jprecision
from hrviton_tpu.data import Loader as JLoader
from hrviton_tpu.data import VitonHDDataset as JDataset
from hrviton_tpu.data import agnostic as jagnostic
from hrviton_tpu.data import collate as jcollate
from hrviton_tpu.data import expand_compact as jexpand
from hrviton_tpu.data import make_synthetic_dataset as jsynthetic
from hrviton_tpu.ops import parse as jparse
from hrviton_tpu_torch.config import DataConfig
from hrviton_tpu_torch.core.precision import bf16_params, f32_params
from hrviton_tpu_torch.data import agnostic as tagnostic
from hrviton_tpu_torch.data.dataset import VitonHDDataset
from hrviton_tpu_torch.data.device import expand_compact
from hrviton_tpu_torch.data.loader import Loader, collate
from hrviton_tpu_torch.data.synthetic import make_synthetic_dataset
from hrviton_tpu_torch.nn.layers import BatchNorm2d, Conv2d, SpectralNorm2d
from hrviton_tpu_torch.ops import parse as tparse

torch.set_num_threads(1)
W, H = 96, 128


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return jsynthetic(str(tmp_path_factory.mktemp("viton_synth")), n=4, w=W,
                      h=H)


def _cfgs(root, datamode):
    kw = dict(dataroot=root, datamode=datamode,
              data_list=f"{datamode}_pairs.txt", fine_height=H, fine_width=W)
    return JDataConfig(**kw), DataConfig(**kw)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (str, list)):
        assert got == want, path
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


# ------------------------------------------------------------------ parse

def test_parse_tables_equal():
    assert tparse.LABELS_20_TO_13 == jparse.LABELS_20_TO_13
    assert tparse.LABELS_13_TO_7 == jparse.LABELS_13_TO_7
    for spec in ("20to13", "13to7"):
        np.testing.assert_array_equal(tparse.remap_matrix(spec),
                                      jparse.remap_matrix(spec))
    np.testing.assert_array_equal(tparse.group_index_of_label20(),
                                  jparse.group_index_of_label20())
    np.testing.assert_array_equal(tparse.group_index_of_label13(),
                                  jparse.group_index_of_label13())


def test_parse_functions_equal():
    rng = np.random.default_rng(0)
    l20 = rng.integers(0, 20, (2, 9, 7)).astype(np.int32)
    l13 = rng.integers(0, 13, (2, 9, 7)).astype(np.int32)
    soft13 = rng.uniform(0, 1, (2, 9, 7, 13)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(tparse.parse20_to_13(t(l20)).numpy(),
                                  np.asarray(jparse.parse20_to_13(l20)))
    oh13 = tparse.onehot(t(l13), 13)
    np.testing.assert_array_equal(oh13.numpy(),
                                  np.asarray(jparse.onehot(jnp.asarray(l13), 13)))
    np.testing.assert_array_equal(tparse.parse13_to_7(oh13).numpy(),
                                  np.asarray(jparse.parse13_to_7(oh13.numpy())))
    np.testing.assert_allclose(tparse.remap_parse(t(soft13), "13to7").numpy(),
                               np.asarray(jparse.remap_parse(soft13, "13to7")),
                               rtol=1e-6, atol=1e-6)
    for table in (tparse.group_index_of_label20(),
                  tparse.group_index_of_label13()):
        labels = l13 if len(table) == 13 else l20
        np.testing.assert_array_equal(
            tparse.lut_lookup(t(labels), table).numpy(),
            np.asarray(jparse.lut_lookup(jnp.asarray(labels), table)))


# --------------------------------------------------------------- agnostic

def _person(root, i):
    base = os.path.join(root, "train")
    name = f"{i:05d}_00"
    im = Image.open(os.path.join(base, "image", name + ".jpg")).convert("RGB")
    parse = Image.open(os.path.join(base, "image-parse-v3", name + ".png"))
    with open(os.path.join(base, "openpose_json",
                           name + "_keypoints.json")) as f:
        pts = np.array(json.load(f)["people"][0]["pose_keypoints_2d"],
                       np.float64).reshape(-1, 3)[:, :2]
    return im, parse, pts


@pytest.mark.parametrize("i", [0, 3])
def test_agnostic_maps_pixel_equal(root, i):
    im, parse, pts = _person(root, i)
    want_pts, got_pts = pts.copy(), pts.copy()
    want = jagnostic.build_cloth_agnostic(im, parse, want_pts)
    got = tagnostic.build_cloth_agnostic(im, parse, got_pts)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(got_pts, want_pts)     # hips rescaled alike
    assert (np.asarray(got) != np.asarray(im)).any()     # something grayed
    want = jagnostic.build_parse_agnostic(parse, pts, w=W, h=H)
    got = tagnostic.build_parse_agnostic(parse, pts, w=W, h=H)
    assert got.mode == want.mode
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------- dataset

@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("mode", ["train", "test", "test_gen"])
def test_dataset_samples_bit_equal(root, mode, compact):
    jcfg, cfg = _cfgs(root, "train" if mode == "train" else "test")
    want_ds = JDataset(jcfg, mode=mode, compact=compact)
    got_ds = VitonHDDataset(cfg, mode=mode, compact=compact)
    assert len(got_ds) == len(want_ds) == 4
    for i in (0, 3):
        _assert_tree_equal(got_ds[i], want_ds[i])


def test_dataset_refusals(root, tmp_path):
    jcfg, cfg = _cfgs(root, "test")
    with pytest.raises(ValueError):
        VitonHDDataset(cfg, mode="val")
    narrow = DataConfig(**{**cfg.__dict__, "semantic_nc": 12})
    with pytest.raises(ValueError, match="semantic_nc"):
        VitonHDDataset(narrow, mode="test")[0]
    wide = DataConfig(**{**cfg.__dict__, "semantic_nc": 16})
    jwide = JDataConfig(**{**jcfg.__dict__, "semantic_nc": 16})
    _assert_tree_equal(VitonHDDataset(wide, mode="test")[1],
                       JDataset(jwide, mode="test")[1])
    # a label outside the 20-label space fails loudly on both sides
    bad = np.zeros((H, W), np.uint8)
    bad[0, 0] = 25
    for ds in (VitonHDDataset(cfg, mode="test"), JDataset(jcfg, mode="test")):
        with pytest.raises(ValueError, match=r"\[25\]"):
            ds._parse_index(bad)


# ----------------------------------------------------------------- loader

def test_collate_nested():
    s = lambda v: {"im_name": f"{v}.jpg", "c_name": {"paired": f"c{v}.jpg"},
                   "cloth": {"paired": np.full((2, 2, 3), v, np.float32)},
                   "image": np.full((2, 2, 3), v, np.uint8)}
    samples = [s(1), s(2), s(3)]
    _assert_tree_equal(collate(samples), jcollate(samples))


@pytest.mark.parametrize("processes", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_batches_equal(root, shuffle, processes):
    jcfg, cfg = _cfgs(root, "test")
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=False, num_workers=2,
              seed=5, worker_processes=processes)
    want = JLoader(JDataset(jcfg, mode="test", compact=True), **kw)
    got = Loader(VitonHDDataset(cfg, mode="test", compact=True), **kw)
    try:
        for _ in range(4):                    # two epochs, ragged tails
            _assert_tree_equal(got.next_batch(), want.next_batch())
    finally:
        got.close()
        want.close()


def test_loader_process_slices(root):
    _, cfg = _cfgs(root, "test")
    ds = VitonHDDataset(cfg, mode="test", compact=True)
    whole = Loader(ds, batch_size=2, shuffle=True, seed=3, num_workers=1)
    parts = [Loader(ds, batch_size=2, shuffle=True, seed=3, num_workers=1,
                    process_id=p, num_processes=2) for p in range(2)]
    try:
        for _ in range(3):
            full = whole.next_batch()
            names = sum((p.next_batch()["im_name"] for p in parts), [])
            assert names == full["im_name"]
    finally:
        for ld in [whole] + parts:
            ld.close()
    with pytest.raises(ValueError):
        Loader(ds, batch_size=3, num_processes=2)


# -------------------------------------------------------------- synthetic

def test_synthetic_trees_byte_equal(tmp_path):
    want = jsynthetic(str(tmp_path / "jax"), n=3, w=64, h=80, seed=7)
    got = make_synthetic_dataset(str(tmp_path / "port"), n=3, w=64, h=80,
                                 seed=7)
    files = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)
                             for d, _, fs in os.walk(r) for f in fs)
    assert files(got) == files(want) and len(files(want)) == 2 * (1 + 3 * 8)
    for rel in files(want):
        assert filecmp.cmp(os.path.join(got, rel), os.path.join(want, rel),
                           shallow=False), rel


# ---------------------------------------------------------- device expand

def _compact_batch(root, mode="test_gen"):
    _, cfg = _cfgs(root, "test")
    ds = VitonHDDataset(cfg, mode=mode, compact=True)
    raw = collate([ds[i] for i in range(3)])
    raw.pop("c_name")
    raw.pop("im_name")
    return raw


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.dtype == torch.bfloat16 \
            else tree.numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32)
                      if tree.dtype == jnp.bfloat16 else tree)


@pytest.mark.parametrize("semantic_nc", [13, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expand_compact_matches_jax(root, dtype, semantic_nc):
    raw = _compact_batch(root)
    want = jexpand(raw, semantic_nc=semantic_nc, dtype=getattr(jnp, dtype))
    got = expand_compact(_tensors(raw), semantic_nc=semantic_nc,
                         dtype=getattr(torch, dtype))
    assert got["image"].dtype == getattr(torch, dtype)
    assert got["parse"].shape[-1] == semantic_nc
    _assert_tree_equal(_as_numpy(got), _as_numpy(want))


def test_expand_compact_flat_cloth_and_refusal(root):
    raw = _compact_batch(root, mode="test")
    for key in ("cloth", "cloth_mask"):
        raw[key] = raw[key]["paired"]
    got = expand_compact(_tensors(raw))
    _assert_tree_equal(_as_numpy(got), _as_numpy(jexpand(raw)))
    assert "agnostic" not in got
    with pytest.raises(ValueError, match="< 13"):
        expand_compact(_tensors(raw), semantic_nc=12)
    with pytest.raises(ValueError, match="< 13"):
        jexpand(raw, semantic_nc=12)


def test_expand_compact_equals_full_format(root):
    """The compact path expanded gives the f32 samples of compact=False."""
    _, cfg = _cfgs(root, "test")
    full = collate([VitonHDDataset(cfg, mode="test_gen")[i] for i in range(3)])
    got = _as_numpy(expand_compact(_tensors(_compact_batch(root))))
    for k in ("cloth", "cloth_mask", "parse", "parse_agnostic", "parse_onehot",
              "pcm", "parse_cloth", "image", "densepose", "pose", "agnostic"):
        _assert_tree_equal(got[k], full[k], k)


# -------------------------------------------------------------- precision

class _Mixed(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 4, 3, padding=1, device="cpu")
        self.bn = BatchNorm2d(4, device="cpu")
        self.sn = SpectralNorm2d(4, 2, 1, device="cpu")
        self.noise_scale = torch.nn.Parameter(torch.zeros(4))
        self.register_buffer("steps", torch.arange(5, dtype=torch.int64))


def test_cast_floating_on_a_module():
    m = _Mixed()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in list(m.parameters()) + list(m.buffers()):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    params = list(m.parameters())
    assert bf16_params(m) is m
    assert all(a is b for a, b in zip(m.parameters(), params))  # kept in place
    # the JAX cast of the same leaves (its pytree policy) gives the same bits
    want = jprecision.bf16_params({k: v.numpy() for k, v in before.items()})
    for k, v in m.state_dict().items():
        if k == "steps":
            assert v.dtype == torch.int64
            torch.testing.assert_close(v, before[k], atol=0, rtol=0)
            continue
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            v.float().numpy(), np.asarray(jnp.asarray(want[k], jnp.float32)))
    f32_params(m)
    assert all(v.dtype == torch.float32 for k, v in m.state_dict().items()
               if k != "steps")
    x = torch.randn(1, 3, 5, 5).contiguous(memory_format=torch.channels_last)
    assert m.sn(m.bn(m.conv(x))).shape == (1, 2, 5, 5)
