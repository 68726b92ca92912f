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
