"""The knockout tools' mains (``hrviton_tpu_torch/tools/exp_*_knockout.py``,
``profile_components.py``) at a tiny size on the CPU, as
test_exp_conv2_main_on_cpu runs exp_conv2's; the training knockout's full
variant against the production step, bit for bit. The plain knocked unit
and gen_knock against the JAX package are in test_torch_knockout.py.
No JAX."""

import contextlib

import pytest
import torch

from hrviton_tpu_torch.models import spade as tspade
from hrviton_tpu_torch.ops import spade_block as tsb
from hrviton_tpu_torch.pipelines import tryon
from test_torch_graphs import _batch, _pipeline

torch.set_num_threads(2)

_TINY = dict(KNOCK_BATCH=1, KNOCK_H=256, KNOCK_W=128, KNOCK_COND_H=64,
             KNOCK_COND_W=64, KNOCK_NGF=8, KNOCK_TOCG_NGF=8, KNOCK_PAIRS=2)


@contextlib.contextmanager
def _tiny(monkeypatch):
    for k, v in _TINY.items():
        monkeypatch.setenv(k, str(v))
    yield


def test_exp_block_knockout_main_on_cpu(monkeypatch, capsys):
    from hrviton_tpu_torch.tools import exp_block_knockout
    with _tiny(monkeypatch):
        out = exp_block_knockout.main(device="cpu")
    names = [u[0] for u in exp_block_knockout.unit_shapes(
        exp_block_knockout.knock_size())]
    assert list(out) == names + ["six units"]
    want = {"full"} | {"+".join(k) for k in tsb.KNOCK_SETS}
    assert all(set(t) == want for t in out.values())
    assert out["six units"]["full"]["ms"] > 0
    assert "attributed" in capsys.readouterr().out


def test_exp_gen_knockout_main_on_cpu(monkeypatch, capsys):
    from hrviton_tpu_torch.tools import exp_gen_knockout
    with _tiny(monkeypatch):
        out = exp_gen_knockout.main(("unit", "skeleton"), device="cpu")
    assert set(out) == {"replayed", "eager"}
    assert set(out["eager"]) == {"full", "unit", "skeleton"}
    assert tspade._GEN_KNOCK == frozenset()
    assert exp_gen_knockout.variant_tags(["skeleton"]) == {
        "skeleton": tspade.KNOCKS}
    assert "eager" in capsys.readouterr().out


def test_exp_cond_knockout_main_on_cpu(monkeypatch):
    from hrviton_tpu_torch.tools import exp_cond_knockout
    with _tiny(monkeypatch):
        out = exp_cond_knockout.main(device="cpu")
    assert set(out) == {"full"} | set(exp_cond_knockout.VARIANTS)


def test_condition_full_variant_is_condition_forward(monkeypatch):
    """The tool's full condition stage computes what condition_forward
    computes (warped cloth and mask, parse7), bit for bit, and the tool's
    own check says so; a stage that drifts from it fails that check."""
    from hrviton_tpu_torch.tools import exp_cond_knockout as ck
    pipe = _pipeline()
    batch = _batch(1)
    with torch.inference_mode():
        c = tryon.condition_forward(pipe.tocg, batch, pipe.cfg)
        warped, parse7 = ck.condition(pipe.tocg, batch, pipe.cfg)
        assert torch.equal(warped, torch.cat([c.warped_cloth,
                                              c.warped_clothmask], -1))
        assert torch.equal(parse7, c.parse7)
        ck.full_equals_production(pipe.tocg, batch, pipe.cfg)
        # a full stage without the blur chain is not condition_forward
        monkeypatch.setattr(ck, "_condition", lambda *a, **k: ck.condition(
            *a, use_blur=False, **k))
        with pytest.raises(RuntimeError, match="not condition_forward"):
            ck.full_equals_production(pipe.tocg, batch, pipe.cfg)


def test_profile_components_main_on_cpu(monkeypatch, capsys):
    from hrviton_tpu_torch.tools import profile_components
    with _tiny(monkeypatch):
        out = profile_components.main(device="cpu")
    assert sum(k.startswith("SPADEResBlock") for k in out) == 8
    assert all(v > 0 for v in out.values())
    assert "FULL pipeline" in capsys.readouterr().out


def test_exp_train_knockout_main_on_cpu(monkeypatch, capsys):
    """The full variant's step equals the production step bit for bit
    (``main`` holds them first; it raises otherwise), then the variants are
    timed; the state advances once a call."""
    from hrviton_tpu_torch.tools import exp_train_knockout
    with _tiny(monkeypatch):
        monkeypatch.setenv("KNOCK_H", "128")
        monkeypatch.setenv("KNOCK_W", "128")
        monkeypatch.setenv("KNOCK_PAIRS", "1")
        out = exp_train_knockout.main(("prod", "no_vgg", "skeleton"),
                                      device="cpu")
    assert set(out) == {"full", "prod", "no_vgg", "skeleton"}
    assert "bit for bit" in capsys.readouterr().out


def test_train_knockout_is_the_cli_step(monkeypatch):
    """The training tool's trainer is configured as the stage-2 CLI's
    defaults configure theirs (the fused unit off, taps wgrad, remat, D
    remat, the norm, the discriminator), with --bf16 and the tool's batch;
    KNOCK_TRAIN_FUSED=1 gives --fused_block's."""
    from hrviton_tpu_torch.cli import train_generator as t2
    from hrviton_tpu_torch.tools import exp_train_knockout as tk
    opt = t2.get_opt(["--name", "s2", "--bf16"])
    with _tiny(monkeypatch):
        monkeypatch.setenv("KNOCK_H", "128")
        monkeypatch.setenv("KNOCK_W", "128")
        tr = tk.build(torch.device("cpu"))[0]
        monkeypatch.setenv("KNOCK_TRAIN_FUSED", "1")
        fused = tk.build(torch.device("cpu"))[0]
    g, d, t = tr.gen_cfg, tr.d_cfg, tr.tcfg
    assert (g.fused_block, g.remat, g.norm_g, g.gen_semantic_nc,
            g.num_upsampling_layers) == (
        opt.fused_block, opt.remat, opt.norm_G, opt.gen_semantic_nc,
        opt.num_upsampling_layers)
    assert (d.ndf, d.n_layers_d, d.num_d) == (opt.ndf, opt.n_layers_D,
                                              opt.num_D)
    assert (t.bf16, t.taps_wgrad, t.d_remat, t.no_vgg_loss,
            t.no_gan_feat_loss) == (opt.bf16, opt.taps_wgrad, opt.d_remat,
                                    opt.no_vgg_loss, opt.no_ganFeat_loss)
    assert fused.gen_cfg.fused_block and not g.fused_block


def test_train_knock_changes_the_step(monkeypatch):
    """A knocked step is another program: after one step from the same
    state, no_opt leaves the Adam moments where they were."""
    from hrviton_tpu_torch.tools import exp_train_knockout as tk
    with _tiny(monkeypatch):
        monkeypatch.setenv("KNOCK_H", "128")
        monkeypatch.setenv("KNOCK_W", "128")
        tr, batch, new_run = tk.build(torch.device("cpu"))
        (full, a), (no_opt, b) = new_run(()), new_run(("no_opt",))
        full()
        no_opt()
    moments = lambda s: s.g.opt.state_tensors()
    assert any(not torch.equal(x, y) for x, y in zip(moments(a), moments(b)))
    fresh = new_run(())[1]
    assert all(torch.equal(x, y) for x, y in zip(moments(b), moments(fresh)))


def test_no_cli_reaches_a_knock():
    """Timing only: no CLI names a knock, a knock tag or a knockout tool."""
    from pathlib import Path
    import hrviton_tpu_torch.cli as cli
    for path in Path(cli.__file__).parent.glob("*.py"):
        assert "knock" not in path.read_text(), path
