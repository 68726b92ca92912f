"""Both training CLIs through the multi-host flags on the CPU: two processes
(``--coordinator 127.0.0.1:<free port> --num_processes 2 --process_id r``,
gloo) and one without the flags, each a child process started together
with a time limit. Two steps at a global batch of 2, one checkpoint
(``--save_count 2``), in-train validation (IoU; LPIPS) on both ranks.

* every process exits 0 and returns its record (the child saves what
  ``main`` returns);
* both ranks print the same metrics (the ranks' averages) and validation
  values;
* the first step's losses, computed before any update, equal the
  one-process run's within 1e-5 relative;
* rank 0 writes the JAX CLIs' checkpoint files; rank 1, given a checkpoint
  directory of its own, writes none.
"""

import os
import sys

import pytest
import torch

from hrviton_tpu_torch.data.synthetic import make_synthetic_dataset
from test_torch_mesh import free_port, run_children

RUN = ("import sys, torch\n"
       "from hrviton_tpu_torch.cli import {cli} as cli\n"
       "torch.save(cli.main(sys.argv[2:]), sys.argv[1])\n")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_cli")
    return (make_synthetic_dataset(str(base / "d64"), n=4, w=64, h=64,
                                   modes=("train", "test")),
            make_synthetic_dataset(str(base / "d128"), n=4, w=128, h=128,
                                   modes=("train", "test")))


def _argv(stage, root, ck, tb):
    common = ["--dataroot", root, "--test_dataroot", root, "-b", "2",
              "-j", "1", "--display_count", "1", "--save_count", "2",
              "--checkpoint_dir", ck, "--tensorboard_dir", tb,
              "--allow_random_vgg", "--device", "cpu"]
    if stage == "train_condition":
        return ["--name", "s1", "--fine_height", "64", "--fine_width", "64",
                "--keep_step", "2", "--val_count", "2", "--val_samples", "4",
                "--tensorboard_count", "2", "--num_test_visualize", "2"] + common
    return ["--name", "s2", "--fine_height", "128", "--fine_width", "128",
            "--cond_height", "64", "--cond_width", "64", "--ngf", "8",
            "--num_upsampling_layers", "more", "--keep_step", "2",
            "--decay_step", "0", "--lpips_count", "2", "--lpips_samples", "2",
            "--lpips_batch", "2", "--tensorboard_count", "2",
            "--num_test_visualize", "2"] + common


FILES = {"train_condition": ["D_final.ckpt", "D_step_000002.ckpt",
                             "tocg_final.ckpt", "tocg_step_000002.ckpt"],
         "train_generator": ["dis_model_final.ckpt", "dis_step_000002.ckpt",
                             "gen_model_final.ckpt", "gen_step_000002.ckpt"]}


@pytest.mark.parametrize("cli", ["train_condition", "train_generator"])
def test_cli_on_two_processes(cli, roots, tmp_path):
    root = roots[0] if cli == "train_condition" else roots[1]
    port = free_port()
    code = RUN.format(cli=cli)
    cmds, recs = [], []
    for tag, flags in [("one", [])] + [
            (f"rank{r}", ["--coordinator", f"127.0.0.1:{port}",
                          "--num_processes", "2", "--process_id", str(r)])
            for r in range(2)]:
        rec = tmp_path / f"{tag}.pt"
        recs.append(rec)
        cmds.append([sys.executable, "-c", code, str(rec)] + _argv(
            cli, root, str(tmp_path / f"ck_{tag}"), str(tmp_path / f"tb_{tag}"))
            + flags)
    run_children(cmds, timeout=400)
    one, r0, r1 = (torch.load(p) for p in recs)
    assert len(r0["metrics"]) == len(r1["metrics"]) == 2
    assert r0["metrics"] == r1["metrics"]
    val = "val_iou" if cli == "train_condition" else "lpips"
    assert len(r0[val]) == 1 and r0[val] == r1[val]
    for k, want in one["metrics"][0].items():
        assert r0["metrics"][0][k] == pytest.approx(want, rel=1e-5, abs=1e-7), k
    name = "s1" if cli == "train_condition" else "s2"
    assert sorted(os.listdir(tmp_path / "ck_rank0" / name)) == FILES[cli]
    assert sorted(os.listdir(tmp_path / "ck_one" / name)) == FILES[cli]
    assert not (tmp_path / "ck_rank1").exists()
