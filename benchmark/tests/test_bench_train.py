"""The training cell ``train-stage2-b2``: the harness finds each of its files
by name, and a run driven on the CPU at a small size (``tiny``: 256x128,
condition 64x64, SPADE ngf 8, D ndf 8, float32) is correct while each
planted fault, and each control one precision down, makes ``correct``
false."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import calibrate_train, check_train
from benchmark import run as bench_run
from benchmark.tests.tiny import BENCH, ROOT

CELL = "train-stage2-b2"
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
SPANS = ("train_cond_ms", "g_forward_ms", "g_backward_ms", "wgrad_taps_ms",
         "regen_ms", "d_step_ms", "optim_ms")
# float32 limits of the tiny cell, over the readings of sound CPU runs
# (warp_mae 5.7e-8, fake_mae 9.8e-7, d_logit_rel 2.6e-6, loss_gap 1.5e-7,
# g_grad_rel 4.4e-3 (the head's instance norms over 2 x 1 pixels),
# g_grad_cos_gap 9.6e-6, d_grad_rel 3.4e-6, d_grad_cos_gap 2e-7, sn_gap 0,
# adam_gap 7.6e-7) and under the TF32 control's, fed the float32
# conditioning (0, 3.3e-3, 2.5e-3, 1.7e-4, 0.85, 0.11, 0.028, 3.7e-4, 0, 0)
TINY_LIMITS = {"warp_mae": 1e-5, "fake_mae": 5e-5, "d_logit_rel": 5e-5,
               "loss_gap": 2e-5, "g_grad_rel": 0.05, "g_grad_cos_gap": 1e-3,
               "d_grad_rel": 5e-3, "d_grad_cos_gap": 1e-5, "sn_gap": 1e-5,
               "adam_gap": 1e-5}
SEED = 3 * 2 ** 31 + 23


def tiny_train_root(tmp, precision="float32", limits=TINY_LIMITS, sample=1):
    """A copy of the benchmark with one more cell, ``tiny``: (root, its
    BENCHMARK.json as a dict, the configuration, the traffic)."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((BENCH / "configs" / "hrviton-train-stage2-bf16.json").read_text())
    cfg.update(name="tiny", precision=precision, limits=limits)
    cfg["pipeline"].update(fine_height=256, fine_width=128, cond_height=64,
                           cond_width=64)
    cfg["generator"]["ngf"] = 8
    cfg["discriminator"]["ndf"] = 8
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = {"driver": "train_closed_loop", "batch": 2, "in_flight": 1,
               "pool": 3, "sample": sample, "profile_steps": 1}
    (root / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    bench = json.loads(json.dumps(BENCHMARK))
    bench["configs"].append({"name": "tiny", "source": "tiny",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny", "config": "tiny",
                               "traffic": "tiny", "chips": 1, "why": "tiny"})
    for m in bench["per_layer"]:
        if CELL in m["workloads"]:
            m["workloads"].append("tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench, cfg, traffic


def test_the_cells_files_are_found_by_name():
    cell, config, traffic, driver = bench_run.cell_setup(BENCHMARK, CELL)
    assert config["name"] == cell["config"] == "hrviton-train-stage2-bf16"
    assert traffic["driver"] == "train_closed_loop"
    assert driver.__file__.endswith("benchmark/drivers/train_closed_loop.py")
    assert traffic["batch"] == config["batch_size"] == 2
    e2e = bench_run.cell_metrics(BENCHMARK, cell, False)
    per = bench_run.cell_metrics(BENCHMARK, cell, True)
    assert set(e2e) == {"setup_s", "img_per_s", "request_ms_p95", "peak_mem_gib"}
    assert set(per) == set(SPANS) | {"train_mfu_pct", "device_idle_pct", "capture_s"}
    for name, (entry, mod) in per.items():
        assert callable(mod.read) and entry["moves"] in e2e
    assert all(hasattr(per[n][1], "probe") for n in SPANS + ("capture_s",))
    # the inference cells' metrics are not the training cell's
    for c in BENCHMARK["workloads"]:
        if c["name"] != CELL:
            assert not set(SPANS) & set(bench_run.cell_metrics(BENCHMARK, c, True))


def test_configuration_keeps_the_published_widths():
    conf = {c["name"]: c for c in BENCHMARK["configs"]}["hrviton-train-stage2-bf16"]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert conf["reduced"] == ["batch_size"] and cfg["batch_size"] == 2
    assert (cfg["generator"]["ngf"], cfg["generator"]["num_upsampling_layers"],
            cfg["discriminator"]["ndf"], cfg["discriminator"]["n_layers_D"],
            cfg["discriminator"]["num_D"], cfg["tocg"]["ngf"]) == (64, "most", 64, 3, 2, 96)
    assert (cfg["pipeline"]["fine_height"], cfg["pipeline"]["fine_width"]) == (1024, 768)
    assert set(cfg["limits"]) == set(check_train.NUMBERS)


def _run(tmp_path, **kw):
    root, bench, _, _ = tiny_train_root(tmp_path, **kw)
    rec, out = bench_run.execute(bench, "tiny", SEED, 0.5, False, "cpu",
                                 root=root, log=lambda m: None)
    return rec, out


@pytest.fixture(scope="module")
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


def test_sound_run_is_correct(tmp_path, _threads):
    rec, out = _run(tmp_path)
    assert out["correct"], out["check"]
    assert rec["wgrad_taps_per_step"] == rec["wgrad_taps_model"] > 0
    assert {"setup_s", "img_per_s", "request_ms_p95"} <= set(out["metrics"])


def _no_feature_matching(monkeypatch):
    from hrviton_tpu_torch.train import generator_trainer
    monkeypatch.setattr(generator_trainer, "feature_matching_loss",
                        lambda fake, real, lam: 0.0 * fake[0][0].float().mean())


def _no_power_iteration(monkeypatch):
    from hrviton_tpu_torch.nn.layers import SpectralNorm2d
    normalized = SpectralNorm2d.normalized_weight
    monkeypatch.setattr(SpectralNorm2d, "normalized_weight",
                        lambda self, dtype, update=False: normalized(self, dtype))


def _d_update_skipped(monkeypatch):
    from hrviton_tpu_torch.cli import train_generator as tgen
    build = tgen.build_training

    def built(opt, mesh):
        out = build(opt, mesh)
        out.state.d.opt.update = lambda: None
        return out
    monkeypatch.setattr(tgen, "build_training", built)


def _no_bias_correction(monkeypatch):
    from hrviton_tpu_torch.train.optim import Adam

    @torch.no_grad()
    def update(self):
        for group in self.opt.param_groups:
            lr, (b1, b2) = float(group["lr"]), group["betas"]
            for p in group["params"]:
                st = self.opt.state[p]
                st["exp_avg"].mul_(b1).add_(p.grad, alpha=1 - b1)
                st["exp_avg_sq"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                st["step"] += 1
                p.addcdiv_(st["exp_avg"], st["exp_avg_sq"].sqrt().add_(1e-8),
                           value=-lr)
    monkeypatch.setattr(Adam, "update", update)


@pytest.mark.parametrize("fault", [_no_feature_matching, _no_power_iteration,
                                   _d_update_skipped, _no_bias_correction],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_caught(tmp_path, monkeypatch, _threads, fault):
    fault(monkeypatch)
    _, out = _run(tmp_path)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("precision, mode", [("float32", "tf32"),
                                             ("bfloat16", "fp8")])
def test_control_one_precision_down_is_caught(tmp_path, _threads, precision,
                                              mode):
    """The reference one precision down in the program's place fails the
    limits: TF32 the tiny float32 cell's, fp8 the training configuration's
    own (bfloat16) limits."""
    limits = TINY_LIMITS if precision == "float32" else None
    root, bench, cfg, traffic = tiny_train_root(tmp_path, precision)
    if limits is None:
        cfg["limits"] = json.loads((BENCH / "configs" /
                                    "hrviton-train-stage2-bf16.json").read_text())["limits"]
    _, _, _, driver = bench_run.cell_setup(bench, "tiny", root)
    nums = calibrate_train.control_numbers(driver, cfg, traffic, SEED,
                                           torch.device("cpu"), mode)
    assert not check_train.judge(nums, cfg["limits"]), nums
