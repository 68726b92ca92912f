"""On the card: the fused SPADE unit's CUDA kernel vs its plain version.

Imports no JAX (the machine with the card has none), so it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``; here,
without a card, each test skips.

Tolerances: f32 with TF32 off, 1e-4 x max|ref| (f32 sums of up to 9*128
products in another order); bf16, 2 bf16 ulps of max|ref| (the plain
version rounds gamma, beta, mod and out to bf16, and a sum in another order
flips single roundings).
"""

import numpy as np
import pytest
import torch

from hrviton_tpu_torch.ops import spade_block as tsb

_ORDER = ("x", "noise", "nscale", "actv", "wg", "bg", "wb", "bb", "wc", "bc")


def _inputs(dtype, b, h, w, c, cout, ksize, residual, nh=128):
    rng = np.random.default_rng(0)

    def a(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()
    t = dict(x=a((b, h, w, c)).to(dtype), noise=a((b, h, w, 1)),
             nscale=a((c,), 0.1), actv=a((b, h, w, nh)).to(dtype),
             wg=a((c, nh, 3, 3), 0.05), bg=a((c,), 0.1),
             wb=a((c, nh, 3, 3), 0.05), bb=a((c,), 0.1),
             wc=a((cout, c, ksize, ksize), 0.05), bc=a((cout,), 0.1))
    res = a((b, h, w, cout)).to(dtype) if residual else None
    return [t[k] for k in _ORDER], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ksize,residual,pre_act", [
    (3, True, "leaky0.2"), (1, False, None), (3, False, "relu")])
def test_kernel_matches_plain(dtype, ksize, residual, pre_act):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # ragged 37x45 tiles exercise every edge mask of the 8x8 tiling
    args, res = _inputs(dtype, 2, 37, 45, 40, 24, ksize, residual)
    before = tsb.spade_conv_unit.launches
    got = tsb.spade_conv_unit(pre_act, *args, res)
    torch.cuda.synchronize()
    assert tsb.spade_conv_unit.launches == before + 1
    want = tsb.spade_conv_ref(*args, pre_act=pre_act, residual=res)
    scale = want.float().abs().max().item()
    tol = 1e-4 * scale if dtype == torch.float32 else 2 * 2 ** -7 * scale
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.gpu
def test_kernel_rejects_bad_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, _ = _inputs(torch.float16, 1, 8, 8, 8, 8, 3, False)
    with pytest.raises(TypeError):
        tsb.spade_conv_unit(None, *args)
