"""The rejection and evaluation CLIs against the JAX package's, on the CPU.

* ``get_opt`` of ``get_norm_const``, ``test_condition`` and ``evaluate``:
  the port's namespace equals the JAX CLI's, less ``device``, for the
  defaults and for a list that sets every flag; ``convert_checkpoint`` and
  ``get_parse_agnostic`` (no ``get_opt``): the parsers ``main`` builds have
  the same options, defaults and choices.
* ``get_norm_const.main`` -> ``test_condition.main`` on a synthetic root
  (6 train and 6 test pairs at 64x64, the condition inputs' tiny size; the
  CLIs' tocg ngf=96, batch 4) with ``--device cpu``, the tocg's ``.ckpt``
  that the JAX package wrote (random) and a ``D.pth`` under the reference's
  key names (random): M within the f32 limit 1e-5 relative of the JAX CLI's
  (both sides sum f32 products in other orders); ``rejection_prob.txt`` the
  same names in the same order, each score within 1e-5 x max|score|; the
  grids the same files, equal but for single uint8 levels: the panels of
  the tocg's f32 outputs are truncated to uint8, and outputs ~1e-6 apart
  move a level now and then (seen: one value in 160,000), so every value
  is within 1 level and at most 1e-4 of them differ; ``--D_checkpoint`` without
  ``--norm_const`` refused as the JAX CLI refuses it.
* ``evaluate.main`` on images written from the test split with noise,
  against the test split's ground truth, LPIPS weights a ``.ckpt`` that the
  JAX package wrote: SSIM and MSE equal (the same host code on the same
  images), LPIPS within 1e-5 relative; IS NaN on both sides without
  ``--inception_weights``; with a ``.pth`` under torchvision's keys the
  port's IS equals ``inception_score`` of its own classifier's softmax.
* ``convert_checkpoint.main`` writes the JAX CLI's bytes; and
  ``get_parse_agnostic.main`` the JAX CLI's maps, pixel for pixel.
"""

import argparse
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hrviton_tpu.cli import convert_checkpoint as jconv
from hrviton_tpu.cli import evaluate as jeval
from hrviton_tpu.cli import get_norm_const as jnorm
from hrviton_tpu.cli import get_parse_agnostic as jagn
from hrviton_tpu.cli import test_condition as jtc
from hrviton_tpu.config import CondDiscriminatorConfig as JDConfig
from hrviton_tpu.config import TOCGConfig as JTOCGConfig
from hrviton_tpu.data import make_synthetic_dataset as jsynthetic
from hrviton_tpu.losses.lpips import LPIPSAlex as JLPIPSAlex
from hrviton_tpu.models import CondMultiscaleDiscriminator as JCondD
from hrviton_tpu.models import ConditionGenerator as JCondition
from hrviton_tpu.train.checkpoint import save_pytree
from hrviton_tpu_torch.cli import convert_checkpoint as tconv
from hrviton_tpu_torch.cli import evaluate as teval
from hrviton_tpu_torch.cli import get_norm_const as tnorm
from hrviton_tpu_torch.cli import get_parse_agnostic as tagn
from hrviton_tpu_torch.cli import test_condition as ttc
from hrviton_tpu_torch.infer.metrics import inception_score
from hrviton_tpu_torch.models.inception import InceptionV3
from hrviton_tpu_torch.nn.layers import init_weights
from test_torch_support import random_variables

torch.set_num_threads(1)
HW = 64


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


# ------------------------------------------------------------------ flags

_DATA = ["--dataroot", "/d", "--datamode", "val", "--data_list", "l.txt",
         "--fine_width", "64", "--fine_height", "96", "-b", "3", "-j", "2",
         "--worker_processes", "--shuffle", "--semantic_nc", "16",
         "--no_device_preprocess", "--warp_feature", "encoder",
         "--out_layer", "conv", "--output_nc", "12",
         "--clothmask_composition", "detach", "--occlusion",
         "--upsample", "nearest", "--fp16", "--gpu_ids", "0,1",
         "--checkpoint_dir", "c", "--tensorboard_dir", "tb",
         "--tensorboard_count", "5", "--tocg_checkpoint", "a.pth",
         "--D_checkpoint", "d.pth", "--Ddownx2", "--Ddropout", "--num_D", "3",
         "--spectral", "--seed", "9"]
_NORM_FULL = _DATA + ["--name", "n", "--display_count", "1", "--keep_step",
                      "2", "--load_step", "3", "--save_count", "4",
                      "--test_data_list", "t.txt", "--test_dataroot", "/t",
                      "--test_datasetting", "paired", "--max_samples", "10"]
_TC_FULL = _DATA + ["--datasetting", "unpaired", "--norm_const", "2.5",
                    "--output_dir", "o"]
_EVAL_FULL = ["--evaluation", "--predict_dir", "p", "--ground_truth_dir", "g",
              "--resolution", "512", "--lpips_weights", "l.ckpt",
              "--inception_weights", "i.pth"]


@pytest.mark.parametrize("cli,argv", [
    ("get_norm_const", []), ("get_norm_const", _NORM_FULL),
    ("test_condition", []), ("test_condition", _TC_FULL),
    ("evaluate", []), ("evaluate", _EVAL_FULL)],
    ids=["norm_defaults", "norm_every_flag", "tc_defaults", "tc_every_flag",
         "eval_defaults", "eval_every_flag"])
def test_get_opt_matches_jax(cli, argv):
    port, ref = {"get_norm_const": (tnorm, jnorm),
                 "test_condition": (ttc, jtc),
                 "evaluate": (teval, jeval)}[cli]
    got = vars(port.get_opt(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(ref.get_opt(argv))
    assert port.get_opt(argv + ["--device", "cpu"]).device == "cpu"


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser that ``main`` builds, caught at parse_args."""
    def catch(self, *a, **k):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as e:
        main([])
    monkeypatch.undo()
    p = e.value.args[0]
    return {tuple(a.option_strings) or a.dest:
            (a.dest, a.default, a.choices, a.required, a.nargs, a.type)
            for a in p._actions}


@pytest.mark.parametrize("cli", ["convert_checkpoint", "get_parse_agnostic"])
def test_parsers_match_jax(cli, monkeypatch):
    port, ref = {"convert_checkpoint": (tconv, jconv),
                 "get_parse_agnostic": (tagn, jagn)}[cli]
    got = _parser_of(port.main, monkeypatch)
    assert got == _parser_of(ref.main, monkeypatch)
    assert len(got) > 2


# ------------------------------------------------- rejection, end to end

def _d_state_dict(v, num_d=2):
    sd = {}
    for d in range(num_d):
        node = v["params"][f"discriminator_{d}"]
        for j, si in enumerate((0, 2, 5, 8, 11)):
            conv = node[f"layer{j}_conv"]["conv"]
            sd[f"layer{d}.{si}.weight"] = torch.from_numpy(np.ascontiguousarray(
                conv["kernel"].transpose(3, 2, 0, 1)))
            sd[f"layer{d}.{si}.bias"] = torch.from_numpy(conv["bias"])
    return sd


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A synthetic root, the JAX package's tocg .ckpt (random, ngf=96 as the
    CLIs build it) and a D.pth under the reference's keys (random)."""
    base = tmp_path_factory.mktemp("rej")
    jsynthetic(str(base / "data"), n=6, w=HW, h=HW, modes=("train", "test"))
    k = jax.random.PRNGKey(0)
    tv = random_variables(JCondition(JTOCGConfig(ngf=96)), k,
                          jnp.zeros((1, HW, HW, 4)), jnp.zeros((1, HW, HW, 16)),
                          train=False, seed=1)
    save_pytree(tv, str(base / "tocg.ckpt"))
    dv = random_variables(JCondD(JDConfig(input_nc=33)), k,
                          jnp.zeros((1, HW, HW, 33)), train=False, seed=2)
    torch.save(_d_state_dict(dv), str(base / "D.pth"))
    return base


def _argv(root, split):
    return ["--dataroot", str(root / "data"), "--datamode", split,
            "--data_list", f"{split}_pairs.txt", "--fine_height", str(HW),
            "--fine_width", str(HW), "-b", "4", "-j", "1",
            "--tocg_checkpoint", str(root / "tocg.ckpt"),
            "--D_checkpoint", str(root / "D.pth")]


def _scores(path):
    rows = [line.split() for line in open(path).read().splitlines()]
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


def test_rejection_chain_matches_jax(root, tmp_path, monkeypatch):
    m_jax = jnorm.main(_argv(root, "train"))
    m_port = tnorm.main(_argv(root, "train") + ["--device", "cpu"])
    assert abs(m_port - m_jax) <= 1e-5 * abs(m_jax), (m_port, m_jax)

    with pytest.raises(SystemExit, match="--norm_const"):
        ttc.main(_argv(root, "test") + ["--device", "cpu"])
    outs = {}
    for side, main in (("jax", jtc.main), ("port", ttc.main)):
        argv = _argv(root, "test") + ["--norm_const", str(m_jax),
                                      "--output_dir", str(tmp_path / side)]
        main(argv + (["--device", "cpu"] if side == "port" else []))
        outs[side] = next((tmp_path / side).rglob("multi-task"))
    names_j, s_j = _scores(outs["jax"] / "rejection_prob.txt")
    names_p, s_p = _scores(outs["port"] / "rejection_prob.txt")
    assert len(names_j) == 6 and names_p == names_j
    assert (np.diff(s_p) <= 0).all()
    assert np.abs(s_p - s_j).max() <= 1e-5 * np.abs(s_j).max()
    grids = sorted(n for n in os.listdir(outs["jax"]) if n.endswith(".png"))
    assert len(grids) == 6
    assert sorted(n for n in os.listdir(outs["port"])
                  if n.endswith(".png")) == grids
    for n in grids:
        a = np.asarray(Image.open(outs["port"] / n))
        b = np.asarray(Image.open(outs["jax"] / n))
        assert a.shape == b.shape == (3 * (HW + 2) + 2, 4 * (HW + 2) + 2, 3)
        d = np.abs(a.astype(np.int32) - b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (n, d.max(),
                                                          (d > 0).mean())


# ------------------------------------------------------------- evaluation

def _predictions(root, out):
    """Each test image with noise, as PNG named <person>_<cloth>.png."""
    os.makedirs(out)
    rng = np.random.default_rng(7)
    gt = root / "data" / "test" / "image"
    for i, name in enumerate(sorted(os.listdir(gt))[:3]):
        img = np.asarray(Image.open(gt / name), np.int32)
        noisy = np.clip(img + rng.integers(-40, 41, img.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(
            out / f"{name.split('_')[0]}_{i:05d}_00.png")
    return gt


def test_evaluate_matches_jax(root, tmp_path):
    z = jnp.zeros((1, 128, 128, 3))
    lv = random_variables(JLPIPSAlex(), jax.random.PRNGKey(0), z, z, seed=3)
    save_pytree(lv, str(tmp_path / "lpips.ckpt"))
    res = {}
    for side, main in (("jax", jeval.main), ("port", teval.main)):
        pred = tmp_path / side
        gt = _predictions(root, pred)
        argv = ["--predict_dir", str(pred), "--ground_truth_dir", str(gt),
                "--lpips_weights", str(tmp_path / "lpips.ckpt")]
        res[side] = main(argv + (["--device", "cpu"] if side == "port" else []))
    (ssim_p, mse_p, lp_p, is_p, isd_p), (ssim_j, mse_j, lp_j, is_j, isd_j) = \
        res["port"], res["jax"]
    assert ssim_p == ssim_j and mse_p == mse_j
    assert 0 < lp_j and abs(lp_p - lp_j) <= 1e-5 * lp_j
    assert np.isnan([is_p, isd_p, is_j, isd_j]).all()
    for f in ("eval.txt", "lpips.txt"):
        lines_p = (tmp_path / "port" / f).read_text().splitlines()
        lines_j = (tmp_path / "jax" / f).read_text().splitlines()
        assert len(lines_p) == len(lines_j) > 0
        assert [ln.split()[0] for ln in lines_p] == \
            [ln.split()[0] for ln in lines_j]
    assert (tmp_path / "port" / "eval.txt").read_text().splitlines()[0] \
        .startswith(f"SSIM : {ssim_j} / MSE : {mse_j} / LPIPS : ")


def test_evaluate_inception_score(root, tmp_path):
    """--inception_weights: a .pth under torchvision's inception_v3 keys
    (random weights): IS is inception_score of the classifier's softmax."""
    net = InceptionV3(device="cpu").eval()
    init_weights(net, torch.Generator().manual_seed(0))
    torch.save(net.state_dict(), str(tmp_path / "inception.pth"))
    pred = tmp_path / "pred"
    gt = _predictions(root, pred)
    got = teval.main(["--predict_dir", str(pred), "--ground_truth_dir",
                      str(gt), "--inception_weights",
                      str(tmp_path / "inception.pth"), "--device", "cpu"])
    names = sorted(n for n in os.listdir(pred) if n.endswith(".png"))
    with torch.no_grad():
        preds = np.stack([torch.softmax(net(teval.inception_input(
            Image.open(pred / n), "cpu")), -1)[0].numpy() for n in names])
    want = inception_score(preds.astype(np.float64))
    assert np.isfinite(got[3:]).all() and got[3] >= 1.0
    assert got[3:] == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------ small CLIs

@pytest.mark.parametrize("kind", ["cond_d", "lpips"])
def test_convert_checkpoint_writes_the_jax_bytes(root, tmp_path, kind):
    src = root / "D.pth"
    extra = []
    if kind == "lpips":
        rng = np.random.default_rng(8)
        alex = {f"features.{i}.{s}": torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
            for i, cin, cout, k in ((0, 3, 64, 11), (3, 64, 192, 5),
                                    (6, 192, 384, 3), (8, 384, 256, 3),
                                    (10, 256, 256, 3))
            for s, shape in (("weight", (cout, cin, k, k)), ("bias", (cout,)))}
        lin = {f"lin{i}.model.1.weight": torch.from_numpy(
            rng.standard_normal((1, c, 1, 1)).astype(np.float32))
            for i, c in enumerate((64, 192, 384, 256, 256))}
        torch.save(alex, str(tmp_path / "alexnet.pth"))
        torch.save(lin, str(tmp_path / "alex.pth"))
        src = tmp_path / "alex.pth"
        extra = ["--backbone", str(tmp_path / "alexnet.pth")]
    jconv.main([kind, str(src), str(tmp_path / "j.ckpt")] + extra)
    tconv.main([kind, str(src), str(tmp_path / "p.ckpt")] + extra)
    assert (tmp_path / "p.ckpt").read_bytes() == \
        (tmp_path / "j.ckpt").read_bytes()


def test_get_parse_agnostic_matches_jax(root, tmp_path):
    data = str(root / "data" / "test")
    jagn.main(["--data_path", data, "--output_path", str(tmp_path / "j")])
    tagn.main(["--data_path", data, "--output_path", str(tmp_path / "p")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert len(names) == 6 and sorted(os.listdir(tmp_path / "p")) == names
    for n in names:
        a, b = Image.open(tmp_path / "p" / n), Image.open(tmp_path / "j" / n)
        assert a.mode == b.mode == "P"
        assert np.array_equal(np.asarray(a), np.asarray(b)), n
