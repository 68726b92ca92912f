"""The port's two training CLIs on the CPU (``--device cpu``), on a
synthetic tree (the port's make_synthetic_dataset): two steps each, and
their checkpoints against the JAX package's readers.

* ``train_condition`` at 64x64 (tocg ngf=96 as the CLI builds it, batch 2)
  and ``train_generator`` (SPADE ngf=8 'more' at 128x128, condition 64x64,
  batch 2, the CLI's defaults: fused unit off, remat, D remat, taps wgrad)
  run two steps with finite losses, IoU validation / in-train LPIPS, and
  write the JAX CLIs' files (``tocg_*.ckpt``, ``D_*.ckpt``, ``gen_*``,
  ``dis_*``);
* every file loads into the JAX package's readers (``restore_into`` /
  ``load_tocg_variables`` / ``load_gen_variables`` with the JAX models'
  variable trees as templates: every key and shape);
* back: JAX-written checkpoints (the JAX ``save_pytree`` of random
  variables) given to the port's CLIs (``--tocg_checkpoint``,
  ``--gen_checkpoint``) with no step to take come out of them bit for bit;
* an incomplete set of the multi-host flags is refused (two processes
  through the whole set: test_torch_mesh_cli.py).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.cli.common import load_gen_variables, load_tocg_variables
from hrviton_tpu.config import CondDiscriminatorConfig as JCondD
from hrviton_tpu.config import SPADEDiscriminatorConfig as JSpadeDConfig
from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.config import TOCGConfig as JTOCGConfig
from hrviton_tpu.models import (CondMultiscaleDiscriminator, ConditionGenerator,
                                SPADEGenerator, SPADEMultiscaleDiscriminator)
from hrviton_tpu.train.checkpoint import load_pytree, restore_into, save_pytree
from hrviton_tpu_torch.cli import train_condition as t1
from hrviton_tpu_torch.cli import train_generator as t2
from hrviton_tpu_torch.data.synthetic import make_synthetic_dataset
from test_torch_support import random_variables

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("train")
    return (make_synthetic_dataset(str(base / "d64"), n=4, w=64, h=64,
                                   modes=("train", "test")),
            make_synthetic_dataset(str(base / "d128"), n=4, w=128, h=128,
                                   modes=("train", "test")))


def _template(module, *shapes, **kw):
    return jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *[jnp.zeros(s) for s in shapes], **kw))


def _equal_trees(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _stage1_argv(root, tmp, steps, extra=()):
    return ["--name", "s1", "--dataroot", root, "--test_dataroot", root,
            "--fine_height", "64", "--fine_width", "64", "-b", "2", "-j", "2",
            "--keep_step", str(steps), "--display_count", "1",
            "--tensorboard_count", "1", "--val_count", "2", "--val_samples",
            "4", "--save_count", "2", "--checkpoint_dir", str(tmp / "ck"),
            "--tensorboard_dir", str(tmp / "tb"), "--allow_random_vgg",
            "--device", "cpu", *extra]


def _stage2_argv(root, tmp, steps, extra=()):
    return ["--name", "s2", "--dataroot", root, "--test_dataroot", root,
            "--fine_height", "128", "--fine_width", "128", "--cond_height",
            "64", "--cond_width", "64", "--ngf", "8",
            "--num_upsampling_layers", "more", "-b", "2", "-j", "2",
            "--keep_step", str(steps), "--decay_step", "0",
            "--display_count", "1", "--tensorboard_count", "2",
            "--lpips_count", "2", "--lpips_samples", "2", "--lpips_batch", "2",
            "--save_count", "2", "--checkpoint_dir", str(tmp / "ck"),
            "--tensorboard_dir", str(tmp / "tb"), "--allow_random_vgg",
            "--device", "cpu", *extra]


def test_train_condition_two_steps_and_jax_readers(roots, tmp_path):
    rec = t1.main(_stage1_argv(roots[0], tmp_path, 2))
    assert len(rec["metrics"]) == 2 and len(rec["val_iou"]) == 1
    for m in rec["metrics"]:
        assert np.isfinite(list(m.values())).all()
        assert {"loss/G", "loss/G/gan", "loss/D", "loss/D/pred_real"} <= set(m)
    ck = tmp_path / "ck" / "s1"
    assert sorted(os.listdir(ck)) == ["D_final.ckpt", "D_step_000002.ckpt",
                                      "tocg_final.ckpt", "tocg_step_000002.ckpt"]
    tocg_t = _template(ConditionGenerator(JTOCGConfig(ngf=96)), (1, 64, 64, 4),
                       (1, 64, 64, 16), train=False)
    tv = load_tocg_variables(str(ck / "tocg_final.ckpt"), tocg_t)
    assert set(tv) == {"params", "batch_stats"}
    d_t = _template(CondMultiscaleDiscriminator(JCondD(input_nc=33)),
                    (1, 64, 64, 33), train=False)
    dv = restore_into(d_t, str(ck / "D_final.ckpt"))
    for a, b in zip(jax.tree_util.tree_leaves(dv), jax.tree_util.tree_leaves(d_t)):
        assert a.shape == b.shape and np.isfinite(a).all()


def test_train_generator_two_steps_and_jax_readers(roots, tmp_path):
    rec = t2.main(_stage2_argv(roots[1], tmp_path, 2))
    assert len(rec["metrics"]) == 2 and len(rec["lpips"]) == 1
    for m in rec["metrics"]:
        assert np.isfinite(list(m.values())).all()
    assert abs(rec["metrics"][0]["loss/dis"] - 2.0) < 0.05   # hinge at init
    ck = tmp_path / "ck" / "s2"
    assert sorted(os.listdir(ck)) == ["dis_model_final.ckpt",
                                      "dis_step_000002.ckpt",
                                      "gen_model_final.ckpt",
                                      "gen_step_000002.ckpt"]
    cfg = JSPADEGenConfig(ngf=8, num_upsampling_layers="more", fine_height=128,
                          fine_width=128)
    gen_t = jax.eval_shape(lambda: SPADEGenerator(cfg).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 128, 9)), jnp.zeros((1, 128, 128, 7)), train=False))
    gv = load_gen_variables(str(ck / "gen_model_final.ckpt"), gen_t, "more")
    assert set(gv) == {"params", "aux"}
    d_t = _template(SPADEMultiscaleDiscriminator(JSpadeDConfig()),
                    (1, 128, 128, 10), train=False)
    dv = restore_into(d_t, str(ck / "dis_model_final.ckpt"))
    assert set(dv) == {"params", "aux"}


def test_jax_checkpoints_load_into_the_port_trainers(roots, tmp_path):
    """JAX-written tocg and generator checkpoints come out of the port's
    CLIs bit for bit when no step is taken."""
    tv = random_variables(ConditionGenerator(JTOCGConfig(ngf=96)),
                          jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)),
                          jnp.zeros((1, 64, 64, 16)), train=False, seed=3)
    save_pytree(tv, str(tmp_path / "tocg.ckpt"))
    t1.main(_stage1_argv(roots[0], tmp_path, 0, ["--tocg_checkpoint",
                                                 str(tmp_path / "tocg.ckpt")]))
    _equal_trees(load_pytree(str(tmp_path / "ck" / "s1" / "tocg_final.ckpt")),
                 load_pytree(str(tmp_path / "tocg.ckpt")))
    cfg = JSPADEGenConfig(ngf=8, num_upsampling_layers="more", fine_height=128,
                          fine_width=128)
    gv = random_variables(SPADEGenerator(cfg), {"params": jax.random.PRNGKey(0),
                                                "noise": jax.random.PRNGKey(1)},
                          jnp.zeros((1, 128, 128, 9)), jnp.zeros((1, 128, 128, 7)),
                          train=False, seed=4)
    save_pytree(gv, str(tmp_path / "gen.ckpt"))
    t2.main(_stage2_argv(roots[1], tmp_path, 0, ["--gen_checkpoint",
                                                 str(tmp_path / "gen.ckpt")]))
    _equal_trees(load_pytree(str(tmp_path / "ck" / "s2" /
                                 "gen_model_final.ckpt")),
                 load_pytree(str(tmp_path / "gen.ckpt")))


@pytest.mark.parametrize("cli", [t1, t2])
@pytest.mark.parametrize("flag,match", [
    (["--coordinator", "h:1"], "--coordinator needs --num_processes and "
                               "--process_id"),
    (["--num_processes", "2"], "need --coordinator"),
    (["--process_id", "1"], "need --coordinator")])
def test_multihost_flags_raise(cli, flag, match):
    """An incomplete set of the multi-host flags is refused before any
    dataset or group is touched (the complete set runs: test_torch_mesh_cli)."""
    with pytest.raises(ValueError, match=match):
        cli.main(["--name", "x", "--device", "cpu", "--allow_random_vgg",
                  *flag])
