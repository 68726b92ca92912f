"""TF32 stays off in every f32 model forward of the port, whatever its entry
point, on the CPU.

torch leaves cuDNN's TF32 on by default, and an f32 library conv issued
under it would run at TF32 precision on the card. Each model is called
directly (no pipeline around it) with cuDNN's and the matmuls'
``allow_tf32`` set to True, while a spy on ``F.conv2d`` and ``F.linear``
records both flags at every call: in f32 every recorded flag is False, and
both read True again after the call; in bf16 every recorded flag is True
(the guard leaves them alone). The flags read the same on the CPU as on the
card, so this holds the guard's placement; ``tests/test_torch_cuda.py``
holds its effect on the card.
"""

import pytest
import torch
import torch.nn.functional as F

from hrviton_tpu_torch.config import (CondDiscriminatorConfig, SPADEGenConfig,
                                      TOCGConfig)
from hrviton_tpu_torch.losses.lpips import LPIPSAlex, LPIPSModel
from hrviton_tpu_torch.models import ConditionGenerator, SPADEGenerator
from hrviton_tpu_torch.models.discriminators import CondMultiscaleDiscriminator
from hrviton_tpu_torch.models.inception import InceptionV3
from hrviton_tpu_torch.nn.layers import init_weights

torch.set_num_threads(1)


def _randn(*shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g).to(dtype)


def _tocg(dtype):
    m = ConditionGenerator(TOCGConfig(ngf=8), device="cpu", dtype=dtype)
    return m, (_randn(1, 64, 64, 4, dtype=dtype),
               _randn(1, 64, 64, 16, dtype=dtype))


def _spade(dtype):
    m = SPADEGenerator(SPADEGenConfig(ngf=8, num_upsampling_layers="more",
                                      fine_height=128, fine_width=64),
                       device="cpu", dtype=dtype)
    return m, (_randn(1, 128, 64, 9, dtype=dtype),
               torch.zeros(1, 128, 64, dtype=torch.int64),
               torch.Generator().manual_seed(0))


def _disc(dtype):
    m = CondMultiscaleDiscriminator(CondDiscriminatorConfig(spectral=True),
                                    device="cpu", dtype=dtype)
    return m, (_randn(1, 64, 64, 33, dtype=dtype),)


def _lpips(dtype):
    m = LPIPSAlex(device="cpu", dtype=dtype)
    return m, (_randn(1, 64, 64, 3), _randn(1, 64, 64, 3) * 0.5)


def _lpips_squeeze_spatial(dtype):
    m = LPIPSModel("squeeze", spatial=True, device="cpu", dtype=dtype)
    return m, (_randn(1, 64, 64, 3), _randn(1, 64, 64, 3) * 0.5)


def _inception(dtype):
    return InceptionV3(device="cpu", dtype=dtype), (_randn(1, 75, 75, 3),)


_MODELS = {"ConditionGenerator": _tocg, "SPADEGenerator": _spade,
           "CondMultiscaleDiscriminator": _disc, "LPIPSAlex": _lpips,
           "LPIPSModel": _lpips_squeeze_spatial, "InceptionV3": _inception}


@pytest.fixture
def spy(monkeypatch):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    seen = []
    for name in ("conv2d", "linear"):
        real = getattr(F, name)

        def record(*a, _real=real, **k):
            seen.append((cudnn.allow_tf32, matmul.allow_tf32))
            return _real(*a, **k)
        monkeypatch.setattr(F, name, record)
    yield seen
    cudnn.allow_tf32, matmul.allow_tf32 = saved


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_f32_forward_runs_without_tf32(spy, name):
    model, args = _MODELS[name](torch.float32)
    init_weights(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.eval()(*args)
    assert len(spy) >= 5
    assert set(spy) == {(False, False)}, name
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (True, True)


@pytest.mark.parametrize("name", ["ConditionGenerator", "SPADEGenerator",
                                  "CondMultiscaleDiscriminator"])
def test_bf16_forward_leaves_the_flags_alone(spy, name):
    model, args = _MODELS[name](torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.eval()(*args)
    assert len(spy) >= 5 and set(spy) == {(True, True)}, name


# ------------------------------------------------------------------ training
# The autograd engine runs a step's backward convs and matmuls after the
# forward's guards have closed, so each trainer runs its whole step (forward,
# backward and optimizer) with TF32 off. A hook on every logit map that
# reaches the GAN loss records both flags when backward gets there.

def _train_spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def flags(g):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return g

    def spy(pred, *a, **k):
        for p in pred:
            t = p[-1] if isinstance(p, (list, tuple)) else p
            if t.requires_grad:
                t.register_hook(flags)
        return real(pred, *a, **k)
    monkeypatch.setattr(module, name, spy)


def _condition_step():
    import numpy as np
    from hrviton_tpu_torch.config import ConditionTrainConfig
    from hrviton_tpu_torch.losses.perceptual import make_vgg_loss
    from hrviton_tpu_torch.train.condition_trainer import ConditionTrainer
    trainer = ConditionTrainer(TOCGConfig(ngf=8),
                               CondDiscriminatorConfig(input_nc=33, ndf=8),
                               ConditionTrainConfig(), device="cpu")
    state = trainer.init(0)
    rng = np.random.default_rng(0)
    f = lambda c: torch.from_numpy(rng.standard_normal((2, 64, 64, c),
                                                       dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 13, (2, 64, 64)))
    parse = torch.nn.functional.one_hot(labels, 13).float()
    batch = {"cloth": {"paired": f(3)}, "cloth_mask": {"paired": f(1)},
             "parse_agnostic": f(13), "densepose": f(3), "parse_onehot": labels,
             "parse": parse, "pcm": parse[..., 3:4], "parse_cloth": f(3)}
    return lambda: trainer.train_step(state, batch,
                                      make_vgg_loss(device="cpu").vgg)


def _generator_step():
    import numpy as np
    from hrviton_tpu_torch.config import (GeneratorTrainConfig, PipelineConfig,
                                          SPADEDiscriminatorConfig)
    from hrviton_tpu_torch.losses.perceptual import make_vgg_loss
    from hrviton_tpu_torch.train.generator_trainer import GeneratorTrainer
    trainer = GeneratorTrainer(
        SPADEGenConfig(ngf=8, num_upsampling_layers="more", fine_height=128,
                       fine_width=64),
        SPADEDiscriminatorConfig(ndf=8), GeneratorTrainConfig(gt_mode=True),
        PipelineConfig(fine_height=128, fine_width=64), None, device="cpu")
    state = trainer.init(0)
    rng = np.random.default_rng(0)
    f = lambda c: torch.from_numpy(rng.standard_normal((2, 128, 64, c),
                                                       dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 13, (2, 128, 64)))
    batch = {"agnostic": f(3), "densepose": f(3), "image": f(3),
             "parse": torch.nn.functional.one_hot(labels, 13).float(),
             "parse_cloth": f(3)}
    frozen = {"vgg": make_vgg_loss(device="cpu").vgg, "tocg": None}
    return lambda: trainer.train_step(state, batch, torch.Generator(),
                                      torch.Generator(), frozen)


@pytest.mark.parametrize("stage", ["condition", "generator"])
@pytest.mark.parametrize("guard", [True, False])
def test_f32_training_backward_runs_without_tf32(monkeypatch, stage, guard):
    """guard=False takes the step's guard out (precision.no_tf32 made a
    no-op): the hooks then see TF32 on, the check's teeth."""
    import contextlib
    from hrviton_tpu_torch.core import precision
    from hrviton_tpu_torch.train import condition_trainer, generator_trainer
    seen = []
    if stage == "condition":
        _train_spy(monkeypatch, condition_trainer, "lsgan_loss", seen)
        step = _condition_step()
    else:
        _train_spy(monkeypatch, generator_trainer, "gan_loss", seen)
        step = _generator_step()
    if not guard:
        monkeypatch.setattr(precision, "no_tf32", contextlib.nullcontext)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        step()
        flags = set(seen)
        after = cudnn.allow_tf32, matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert len(seen) >= 4
    assert flags == ({(False, False)} if guard else {(True, True)})
    assert after == (True, True)
