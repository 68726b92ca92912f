"""The port's inference CLI and its helpers against the JAX package's, on the
CPU.

* ``get_opt``: the port's namespace equals the JAX CLI's, less ``device``,
  for the defaults and for a list that sets every flag.
* ``utils/vis.py``: the palette lookup gives PIL's palette RGB, and
  ``to_uint8``, ``make_image_grid`` and ``save_images`` give the same arrays
  and bytes.
* ``main`` on a synthetic root (2 samples, fine 256x128, condition 64x64,
  SPADE ngf=8; the CLI's tocg ngf=96) with ``--device cpu`` and ``.ckpt``
  weights that the JAX package wrote (random, SPADE ``noise_scale`` zero:
  the two packages draw their noise from different generators), in the
  compact and in the ``--no_device_preprocess`` format: the same output and
  grid file names as the JAX CLI, and decoded pixels within stated limits.
  The two sides' f32 forwards differ by ~1e-5 (rgb at most 0.006 apart
  here), which moves a uint8 level now and then, and where a blurred parse
  logit ties, the argmax may flip (the pipeline test allows 0.1% of the
  labels). Limits: the grids (PNG, lossless, the rgb their last panel) every
  value within 1 level (uint8 truncation) but for 0.1% of them, and 0.1
  level on average (seen: 1 and 0.03); the outputs (JPEG, whose
  quantisation turns a moved level into flipped DCT coefficients of its
  8x8 block, 29 levels at most seen) compared as means over 16x16 blocks,
  which flipped AC coefficients leave alone: within 4 levels (seen 1.9).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hrviton_tpu.cli import test_generator as jcli
from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.config import TOCGConfig as JTOCGConfig
from hrviton_tpu.data import make_synthetic_dataset as jsynthetic
from hrviton_tpu.models import ConditionGenerator as JCondition
from hrviton_tpu.models import SPADEGenerator as JSPADE
from hrviton_tpu.train.checkpoint import save_pytree
from hrviton_tpu.utils import vis as jvis
from hrviton_tpu_torch.cli import test_generator as tcli
from hrviton_tpu_torch.utils import vis as tvis
from test_torch_support import random_variables

torch.set_num_threads(1)
FH, FW, CH, CW, NGF = 256, 128, 64, 64, 8


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


_FULL = ["--test_name", "t2", "--dataroot", "/d", "--datamode", "train",
         "--data_list", "l.txt", "--fine_width", "64", "--fine_height", "96",
         "-b", "3", "-j", "2", "--worker_processes", "--shuffle",
         "--semantic_nc", "16", "--no_device_preprocess",
         "--warp_feature", "encoder", "--out_layer", "conv", "--output_nc", "12",
         "--clothmask_composition", "detach", "--occlusion",
         "--upsample", "nearest", "--cuda", "--fp16", "--gpu_ids", "0,1",
         "--checkpoint_dir", "c", "--tensorboard_dir", "tb",
         "--tensorboard_count", "5", "--norm_G", "aliasbatch", "--ngf", "32",
         "--gen_semantic_nc", "8", "--num_upsampling_layers", "more",
         "--init_type", "normal", "--init_variance", "0.1",
         "--output_dir", "o", "--datasetting", "paired",
         "--tocg_checkpoint", "a.pth", "--gen_checkpoint", "b.ckpt",
         "--cond_height", "128", "--cond_width", "96", "--bf16", "--no_grids",
         "--seed", "9"]


@pytest.mark.parametrize("argv", [[], _FULL], ids=["defaults", "every_flag"])
def test_get_opt_matches_jax(argv):
    got = vars(tcli.get_opt(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jcli.get_opt(argv))


def test_get_opt_device():
    assert tcli.get_opt(["--device", "cpu"]).device == "cpu"


def test_visualize_segmap_matches_pil():
    rng = np.random.default_rng(0)
    seg = rng.standard_normal((2, 9, 11, 13)).astype(np.float32)
    seg[1, :, :, 0] += 10.0                   # one label everywhere
    for b in (0, 1):
        got = tvis.visualize_segmap(seg, b)
        np.testing.assert_array_equal(got, jvis.visualize_segmap(seg, b))
    wide = np.zeros((1, 4, 4, 30), np.float32)
    wide[0, :, :, 25] = 1.0                   # past the 20-entry palette
    np.testing.assert_array_equal(tvis.visualize_segmap(wide),
                                  jvis.visualize_segmap(wide))


def test_images_and_grid_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    imgs = rng.uniform(-1.2, 1.2, (2, 10, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.to_uint8(imgs), jvis.to_uint8(imgs))
    panels = [rng.uniform(0, 1, (10, 6, 3)), rng.uniform(0, 1, (10, 6, 1)),
              rng.uniform(0, 1, (8, 6)), rng.uniform(-0.5, 1.5, (10, 6, 3)),
              rng.uniform(0, 1, (10, 6, 3))]
    grid = tvis.make_image_grid(panels, nrow=4)
    assert grid.shape == (2 * 12 + 2, 4 * 8 + 2, 3)
    np.testing.assert_array_equal(grid, jvis.make_image_grid(panels, nrow=4))
    tvis.save_images(imgs, ["a.png", "b.png"], str(tmp_path / "port"))
    jvis.save_images(imgs, ["a.png", "b.png"], str(tmp_path / "jax"))
    for n in ("a.png", "b.png"):
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """A synthetic root and the JAX package's .ckpt files of random
    weights (tocg ngf=96 as the CLI builds it; SPADE noise_scale zero)."""
    base = tmp_path_factory.mktemp("cli")
    jsynthetic(str(base / "data"), n=2, w=FW, h=FH, modes=("test",))
    k = jax.random.PRNGKey(0)
    tv = random_variables(JCondition(JTOCGConfig(ngf=96)), k,
                          jnp.zeros((1, CH, CW, 4)), jnp.zeros((1, CH, CW, 16)),
                          train=False, seed=1)
    gv = random_variables(
        JSPADE(JSPADEGenConfig(ngf=NGF, fine_height=FH, fine_width=FW,
                               remat=False)),
        {"params": k, "noise": k}, jnp.zeros((1, FH, FW, 9)),
        jnp.zeros((1, FH, FW, 7)), train=False, seed=2)
    zero_noise(gv["params"])
    save_pytree(tv, str(base / "tocg.ckpt"))
    save_pytree(gv, str(base / "gen.ckpt"))
    return base


def zero_noise(tree):
    for k, v in tree.items():
        if k == "noise_scale":
            tree[k] = np.zeros_like(v)
        elif isinstance(v, dict):
            zero_noise(v)


def _files(d):
    return sorted(os.listdir(d))


def _decoded(d, n):
    return np.asarray(Image.open(os.path.join(d, n)), np.float64)


def _blocks(x, s=16):
    h, w, c = x.shape
    return x.reshape(h // s, s, w // s, s, c).mean(axis=(1, 3))


@pytest.mark.parametrize("fmt", [[], ["--no_device_preprocess"]],
                         ids=["compact", "full"])
def test_main_matches_jax_cli(cli_root, tmp_path, monkeypatch, fmt):
    argv = ["--dataroot", str(cli_root / "data"),
            "--tocg_checkpoint", str(cli_root / "tocg.ckpt"),
            "--gen_checkpoint", str(cli_root / "gen.ckpt"),
            "--output_dir", "out", "--fine_height", str(FH),
            "--fine_width", str(FW), "--cond_height", str(CH),
            "--cond_width", str(CW), "--ngf", str(NGF), "-j", "1"] + fmt
    runs = {}
    for side, main in (("jax", jcli.main), ("port", tcli.main)):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        main(argv + (["--device", "cpu"] if side == "port" else []))
        runs[side] = tmp_path / side
    grid = os.path.join("output", "test", "test", "unpaired", "generator",
                        "grid")
    names = _files(runs["jax"] / "out")
    assert names == ["00000_00_00001_00.png", "00001_00_00000_00.png"]
    assert _files(runs["port"] / "out") == names
    assert _files(runs["port"] / grid) == _files(runs["jax"] / grid) == names
    for n in names:
        a, b = _decoded(runs["port"] / grid, n), _decoded(runs["jax"] / grid, n)
        assert a.shape == b.shape == (3 * (FH + 2) + 2, 4 * (FW + 2) + 2, 3)
        d = np.abs(a - b)
        assert (d > 1).mean() <= 1e-3 and d.mean() <= 0.1, (n, d.max(), d.mean())
        a, b = _decoded(runs["port"] / "out", n), _decoded(runs["jax"] / "out", n)
        assert a.shape == b.shape == (FH, FW, 3)
        assert np.abs(_blocks(a) - _blocks(b)).max() <= 4.0, n
    img = np.asarray(Image.open(runs["port"] / "out" / names[0]))
    assert img.shape == (FH, FW, 3) and 20 < img.std() < 120


# ----------------------------------------------------- the training CLIs

from hrviton_tpu.cli import train_condition as jtc  # noqa: E402
from hrviton_tpu.cli import train_generator as jtg  # noqa: E402
from hrviton_tpu_torch.cli import train_condition as ttc  # noqa: E402
from hrviton_tpu_torch.cli import train_generator as ttg  # noqa: E402

_TRAIN_COMMON = ["--dataroot", "/d", "--datamode", "val", "--data_list", "l.txt",
                 "--fine_width", "64", "--fine_height", "96", "-b", "3", "-j",
                 "2", "--worker_processes", "--shuffle", "--semantic_nc", "16",
                 "--no_device_preprocess", "--warp_feature", "encoder",
                 "--out_layer", "conv", "--output_nc", "12",
                 "--clothmask_composition", "detach", "--occlusion",
                 "--upsample", "nearest", "--cuda", "--gpu_ids", "0,1",
                 "--tensorboard_dir", "tb", "--checkpoint_dir", "c",
                 "--tocg_checkpoint", "a.ckpt", "--vgg_weights", "v.ckpt",
                 "--allow_random_vgg", "--tensorboard_count", "5",
                 "--display_count", "6", "--save_count", "7", "--load_step",
                 "8", "--keep_step", "9", "--test_dataroot", "/t",
                 "--test_data_list", "t.txt", "--G_lr", "0.5", "--D_lr", "0.25",
                 "--fp16", "--seed", "4", "--coordinator", "h:1",
                 "--num_processes", "2", "--process_id", "1",
                 "--num_test_visualize", "2", "--num_D", "3",
                 "--test_datasetting", "x"]
_TRAIN_FULL = {
    "train_condition": (jtc, ttc, _TRAIN_COMMON + [
        "--name", "n", "--Ddownx2", "--Ddropout", "--spectral",
        "--G_D_seperate", "--no_GAN_loss", "--lasttvonly", "--interflowloss",
        "--edgeawaretv", "weighted", "--add_lasttv", "--no_test_visualize",
        "--CElamda", "3", "--GANlambda", "2", "--tvlambda", "1",
        "--val_count", "11", "--val_samples", "12"]),
    "train_generator": (jtg, ttg, _TRAIN_COMMON + [
        "--name", "n", "--GMM_const", "--grid_size", "5", "--lambda_l1", "1",
        "--netD_subarch", "n", "--radius", "3", "--norm_G", "aliasbatch",
        "--ngf", "32", "--gen_semantic_nc", "8", "--num_upsampling_layers",
        "more", "--init_type", "normal", "--init_variance", "0.1",
        "--gen_checkpoint", "g.ckpt", "--dis_checkpoint", "d.ckpt",
        "--lpips_weights", "l.ckpt", "--no_taps_wgrad", "--fused_block",
        "--no_remat", "--no_d_remat", "--decay_step", "13",
        "--lpips_count", "14", "--lpips_samples", "15", "--lpips_batch", "5",
        "--no_ganFeat_loss", "--no_vgg_loss", "--lambda_feat", "2",
        "--lambda_vgg", "3", "--n_layers_D", "4", "--ndf", "32",
        "--norm_D", "spectralbatch", "--GT", "--cond_height", "128",
        "--cond_width", "96"]),
}


@pytest.mark.parametrize("name", sorted(_TRAIN_FULL))
@pytest.mark.parametrize("every", [False, True], ids=["defaults", "every_flag"])
def test_training_get_opt_matches_jax(name, every):
    jmod, tmod, full = _TRAIN_FULL[name]
    argv = full if every else ["--name", "n"]
    got = vars(tmod.get_opt(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jmod.get_opt(argv))


@pytest.mark.parametrize("name", sorted(_TRAIN_FULL))
def test_training_get_opt_registers_every_jax_flag(name):
    """Every option string of the JAX CLI's parser is the port's too."""
    import argparse
    jmod, tmod, _ = _TRAIN_FULL[name]

    def flags(mod):
        seen = set()
        real = argparse.ArgumentParser.parse_args

        def grab(self, *a, **k):
            seen.update(s for act in self._actions for s in act.option_strings)
            return real(self, ["--name", "n"])
        argparse.ArgumentParser.parse_args = grab
        try:
            mod.get_opt([])
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen
    assert flags(jmod) <= flags(tmod)
    assert flags(tmod) - flags(jmod) == {"--device"}
