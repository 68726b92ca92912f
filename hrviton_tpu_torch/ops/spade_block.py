"""Fused {SPADE-norm -> activation -> consumer conv} unit.

PyTorch counterpart of ``hrviton_tpu/ops/spade_block.py``. One call fuses one
of a SPADEResBlock's three {SPADENorm, conv} pairs:

    mu, rsig   = instance stats of x + noise*nscale   # plain torch, f32
    actv       = conv_shared(seg)                     # caller, pre-relu
    ------------------------------------------------------------- in-kernel:
    xn         = x + noise * nscale
    normalized = (xn - mu) * rsig
    mod        = normalized * (1 + conv_g(relu(actv))) + conv_b(relu(actv))
    out        = conv(act(mod), Wc) + bias [+ residual]

The kernel is CUDA C++ for sm_90a (``csrc/spade_block.cu``): bf16 inputs
run on the tensor cores, f32 inputs on plain FMA loops. It is built with
``nvcc`` at first use into ``build/`` at the repository root (keyed by a hash
of the source) and loaded with ctypes. ``spade_conv_unit`` launches it for
CUDA tensors and takes the plain formulation ``spade_conv_ref`` only for CPU
tensors; a CUDA tensor never reaches the plain version through it.

Layouts: activations NHWC (contiguous), weights OIHW (the port's module
layout). ``noise`` is (B, H, W, 1) float32, as the JAX package draws it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from hrviton_tpu_torch.nn.layers import activation

__all__ = ["spade_conv_unit", "spade_conv_ref", "fused_spade_conv_eligible",
           "build", "unit_flops", "unit_bytes"]

_EPS = 1e-5
_MIN_H = 256          # the JAX gate's row floor: admits up_3 and up_4 only
_ACTS = {None: 0, "relu": 1, "leaky0.2": 2}
_DTYPES = (torch.float32, torch.bfloat16)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "spade_block.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
_LIB = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "hrviton_tpu_torch/csrc/spade_block.cu")


def build(verbose: bool = False) -> Path:
    """Compile the kernel (once per source hash) and return the library path.
    With ``verbose`` the compiler's resource report (-Xptxas -v) is printed."""
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"spade_block_{key}.so"
    if lib.exists() and not verbose:
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, lib)
    return lib


def _library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.spade_unit_forward.argtypes = [vp] * 12 + [i] * 10 + [vp]
            lib.spade_unit_forward.restype = ctypes.c_int
            lib.spade_unit_smem_bytes.argtypes = [i, i, i]
            lib.spade_unit_smem_bytes.restype = ctypes.c_size_t
            lib.spade_unit_forward_bf16.argtypes = [vp] * 12 + [i] * 11 + [vp]
            lib.spade_unit_forward_bf16.restype = ctypes.c_int
            lib.spade_unit_tc_smem_bytes.argtypes = [i] * 5
            lib.spade_unit_tc_smem_bytes.restype = ctypes.c_size_t
            _LIB = lib
    return _LIB


def fused_spade_conv_eligible(h: int, w: int, nh: int, dtype,
                              device) -> bool:
    """Shape gate: the JAX gate's shape rules (h % 8 == 0, w % 128 == 0,
    nh % 128 == 0, h >= 256), which admit up_3 and up_4 at 1024x768 and
    nothing else, on a CUDA device, in float32 or bfloat16. Always false on
    the CPU, where the unfused plain path runs."""
    return (torch.device(device).type == "cuda" and dtype in _DTYPES
            and h % 8 == 0 and w % 128 == 0 and nh % 128 == 0
            and h >= _MIN_H)


def _stats(x, noise, nscale):
    """f32 per-(batch, channel) instance stats of x + noise*nscale (NHWC):
    mean and 1/sqrt(biased var + eps), in one var_mean pass."""
    xnf = (x + (noise * nscale).to(x.dtype)).float()
    var, mu = torch.var_mean(xnf, dim=(1, 2), correction=0)
    return mu, torch.rsqrt(var + _EPS)


def spade_conv_ref(x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                   pre_act=None, residual=None):
    """Plain PyTorch formulation of the unit (the CPU path and the gold).

    x: (B, H, W, C); noise: (B, H, W, 1) f32; nscale: (C,); actv: (B, H, W,
    NH) pre-relu; wg/wb: (C, NH, 3, 3); bg/bb: (C,); wc: (cout, C, k, k);
    bc: (cout,) or None; residual: (B, H, W, cout) or None. NHWC out.
    """
    dtype = x.dtype
    xn = x + (noise * nscale).to(dtype)
    xnf = xn.float()
    mu = xnf.mean(dim=(1, 2), keepdim=True)
    var = (xnf - mu).square().mean(dim=(1, 2), keepdim=True)
    normalized = ((xnf - mu) * torch.rsqrt(var + _EPS)).to(dtype)
    a = F.relu(actv).permute(0, 3, 1, 2)
    gamma = F.conv2d(a, wg.to(dtype), padding=1).permute(0, 2, 3, 1) \
        + bg.to(dtype)
    beta = F.conv2d(a, wb.to(dtype), padding=1).permute(0, 2, 3, 1) \
        + bb.to(dtype)
    mod = activation(normalized * (1.0 + gamma) + beta, pre_act)
    pad = wc.shape[-1] // 2
    y = F.conv2d(mod.permute(0, 3, 1, 2), wc.to(dtype),
                 padding=pad).permute(0, 2, 3, 1)
    if bc is not None:
        y = y + bc.to(y.dtype)
    if residual is not None:
        y = y + residual
    return y


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _pack_weights(wg, bg, wb, bb, wc, bc):
    """float32 kernel layouts: wgb (9, NH/4, CP, 8) [gamma k0..3 | beta
    k0..3]; bgb (2, CP); wck (k*k, C, COUTP); bck (COUTP,). Zero padding on
    the channel axes (CP, COUTP: multiples of 32)."""
    c, nh = wg.shape[0], wg.shape[1]
    cout, ks = wc.shape[0], wc.shape[-1]
    cp, coutp = _pad_to(c, 32), _pad_to(cout, 32)

    def quads(w):   # (C, NH, 3, 3) -> (9, NH/4, C, 4)
        return w.permute(2, 3, 1, 0).reshape(9, nh // 4, 4, c).permute(0, 1, 3, 2)

    f32 = torch.float32
    wgb = torch.cat([quads(wg), quads(wb)], dim=-1).to(f32)
    wgb = F.pad(wgb, (0, 0, 0, cp - c)).contiguous()
    bgb = F.pad(torch.stack([bg, bb]).to(f32), (0, cp - c)).contiguous()
    wck = wc.permute(2, 3, 1, 0).reshape(ks * ks, c, cout).to(f32)
    wck = F.pad(wck, (0, coutp - cout)).contiguous()
    if bc is None:
        bck = torch.zeros(coutp, dtype=f32, device=wc.device)
    else:
        bck = F.pad(bc.to(f32), (0, coutp - cout)).contiguous()
    return wgb, bgb, wck, bck, cp, coutp


def _pack_weights_tc(wg, bg, wb, bb, wc, bc):
    """bf16 tensor-core layouts (row-major K x N B operands): wgb (NPASS,
    9*NH, 64), pass p holding [gamma | beta] of channel tiles 2p and 2p+1
    (16 columns each, zeros past the last tile); bgb (2, CP) f32; wck (k*k,
    CP, COUTP); bck (COUTP,) f32. CP, COUTP: channels padded to 16 with
    zeros; biases rounded through bf16."""
    c, nh = wg.shape[0], wg.shape[1]
    cout, ks = wc.shape[0], wc.shape[-1]
    cp, coutp = _pad_to(c, 16), _pad_to(cout, 16)
    npass = (cp // 16 + 1) // 2
    bf = torch.bfloat16

    def tiles(w):   # (C, NH, 3, 3) -> (9*NH, 2*NPASS, 16)
        k = F.pad(w.permute(2, 3, 1, 0).reshape(9 * nh, c), (0, 32 * npass - c))
        return k.reshape(9 * nh, 2 * npass, 16)

    wgb = torch.stack([tiles(wg), tiles(wb)], dim=2)        # (9NH, 2NP, 2, 16)
    wgb = wgb.reshape(9 * nh, npass, 64).transpose(0, 1).to(bf).contiguous()
    bgb = F.pad(torch.stack([bg, bb]).to(bf).float(), (0, cp - c)).contiguous()
    wck = wc.permute(2, 3, 1, 0).reshape(ks * ks, c, cout)
    wck = F.pad(wck, (0, coutp - cout, 0, cp - c)).to(bf).contiguous()
    if bc is None:
        bck = torch.zeros(coutp, dtype=torch.float32, device=wc.device)
    else:
        bck = F.pad(bc.to(bf).float(), (0, coutp - cout)).contiguous()
    return wgb, bgb, wck, bck, cp, coutp


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _fused_cuda(pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                residual):
    if x.dtype not in _DTYPES:
        raise TypeError(f"spade_conv_unit kernel takes float32/bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    nh = actv.shape[-1]
    cout, ks = wc.shape[0], wc.shape[-1]
    if nh % 4 or ks not in (1, 3) or wc.shape[1] != c or tuple(wg.shape) != (c, nh, 3, 3):
        raise ValueError(f"unsupported unit shapes: x {tuple(x.shape)}, actv "
                         f"{tuple(actv.shape)}, wg {tuple(wg.shape)}, wc {tuple(wc.shape)}")
    dev = x.device
    _check("x", x, (n, h, w, c), x.dtype, dev)
    _check("actv", actv, (n, h, w, nh), x.dtype, dev)
    noise = noise.reshape(n, h, w)
    _check("noise", noise, (n, h, w), torch.float32, dev)
    if residual is not None:
        _check("residual", residual, (n, h, w, cout), x.dtype, dev)
    lib = _library()
    tc = x.dtype == torch.bfloat16
    if tc:
        cp = _pad_to(c, 16)
        cs = cp + 8                             # spread shared-memory banks
        smem = lib.spade_unit_tc_smem_bytes(ks, nh, cp, _pad_to(cout, 16), cs)
    else:
        smem = lib.spade_unit_smem_bytes(ks, nh, c)
    if smem == 0 or smem > _SMEM_LIMIT or (tc and (c % 8 or cout % 8)):
        raise ValueError(f"unsupported unit: c={c} cout={cout} nh={nh} k={ks} "
                         f"{x.dtype} ({smem} B of shared memory)")

    mu, rsig = _stats(x, noise[..., None], nscale)
    nsc = nscale.float().contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = residual.data_ptr() if residual is not None else None
    if tc:
        wgb, bgb, wck, bck, cp, coutp = _pack_weights_tc(wg, bg, wb, bb, wc, bc)
        err = lib.spade_unit_forward_bf16(
            x.data_ptr(), noise.data_ptr(), nsc.data_ptr(), mu.data_ptr(),
            rsig.data_ptr(), actv.data_ptr(), wgb.data_ptr(), bgb.data_ptr(),
            wck.data_ptr(), bck.data_ptr(), res, out.data_ptr(),
            n, h, w, c, nh, cout, cp, coutp, cs, ks, _ACTS[pre_act], stream)
    else:
        wgb, bgb, wck, bck, cp, coutp = _pack_weights(wg, bg, wb, bb, wc, bc)
        err = lib.spade_unit_forward(
            x.data_ptr(), noise.data_ptr(), nsc.data_ptr(), mu.data_ptr(),
            rsig.data_ptr(), actv.data_ptr(), wgb.data_ptr(), bgb.data_ptr(),
            wck.data_ptr(), bck.data_ptr(), res, out.data_ptr(),
            n, h, w, c, nh, cout, cp, coutp, ks, _ACTS[pre_act], stream)
    if err != 0:
        raise RuntimeError(f"spade_unit_forward launch failed: cudaError {err}")
    spade_conv_unit.launches += 1
    return out


def spade_conv_unit(pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                    residual: Optional[torch.Tensor] = None):
    """Fused unit (argument order of the JAX ``spade_conv_unit``).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    formulation. ``spade_conv_unit.launches`` counts kernel launches.
    """
    if pre_act not in _ACTS:
        raise ValueError(pre_act)
    if x.device.type == "cpu":
        return spade_conv_ref(x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                              pre_act=pre_act, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"spade_conv_unit: unsupported device {x.device}")
    return _fused_cuda(pre_act, x, noise, nscale, actv, wg, bg, wb, bb, wc, bc,
                       residual)


spade_conv_unit.launches = 0


def unit_flops(b, h, w, c, cout, ks, nh=128) -> int:
    """Operations the unit needs (2 per multiply-add): gamma and beta 3x3
    convs over nh channels plus the consumer conv. Elementwise work is
    negligible beside them and is not counted."""
    return 2 * b * h * w * (2 * 9 * nh * c + ks * ks * c * cout)


def unit_bytes(b, h, w, c, cout, ks, nh=128, elem=2, residual=False) -> int:
    """Bytes the unit must move: x, actv, noise (f32), residual read once,
    out written once, weights read once."""
    px = b * h * w
    act = px * (c + nh + cout * (2 if residual else 1)) * elem + px * 4
    weights = (2 * 9 * nh * c + ks * ks * c * cout) * elem
    return act + weights
