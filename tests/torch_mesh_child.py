"""One rank of a data-parallel scenario of the port, on the CPU (gloo).

    python tests/torch_mesh_child.py SCENARIO WORLD RANK PORT OUT

Run by tests/test_torch_mesh.py: WORLD processes (ranks 0..WORLD-1) join a
gloo group at 127.0.0.1:PORT and each steps on its rows of one global batch;
with WORLD 1 the process joins no group (the one-process reference). WORLD
"1r" is the reference on every batch with its samples in reverse order, and
"1s" with them shifted by one row, the random draws (dropout masks, SPADE
noise) reordered with them: the same computation in exact arithmetic,
summed in other orders, which measures the reference's own f32 rounding
noise. Each rank saves what it ends with to
OUT/<SCENARIO>_<WORLD>_<RANK>.pt: outputs, the gradients of every step,
every parameter and buffer after every step, the metrics. Imports no JAX.

Scenarios:
  bn           BatchNorm2d (affine and not) in training mode: output, input
               and parameter gradients, the staged running statistics;
  cond         two ConditionTrainer steps, tocg ngf=8 at 64x64, the
               condition discriminator (ndf 8) with BatchNorm and
               --Ddropout;
  gen_instance two GeneratorTrainer steps, SPADE ngf=8 'more' at 64x64
  gen_batch    (--GT), 'spectralaliasinstance' / 'spectralaliasbatch'.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hrviton_tpu_torch.config import (CondDiscriminatorConfig,  # noqa: E402
                                      ConditionTrainConfig,
                                      GeneratorTrainConfig, PipelineConfig,
                                      SPADEDiscriminatorConfig,
                                      SPADEGenConfig, TOCGConfig)
from hrviton_tpu_torch.core import mesh as mesh_lib  # noqa: E402
from hrviton_tpu_torch.models.backbones import Vgg19Features  # noqa: E402
from hrviton_tpu_torch.nn.layers import (BatchNorm2d, Conv2d,  # noqa: E402
                                         commit_state, init_weights)

GLOBAL_BATCH = 4
HW = 64
# the reference's row order: None, "r" (reversed) or "s" (shifted by one)
ORDER = None


def _reorder(t):
    """A batch's (or a draw's) rows in the ORDER of this run."""
    if ORDER == "r":
        return t.flip(0) if torch.is_tensor(t) else t[::-1]
    if ORDER == "s":
        return t.roll(-1, 0) if torch.is_tensor(t) else np.roll(t, -1, 0)
    return t


def _rows(tree, mesh):
    """The rank's rows of a global numpy batch, as tensors."""
    if isinstance(tree, dict):
        return {k: _rows(v, mesh) for k, v in tree.items()}
    tree = _reorder(tree)
    n = tree.shape[0] // mesh.world_size
    return torch.from_numpy(np.ascontiguousarray(tree[mesh.rows(n)]))


def _reorder_draws():
    """The models' draws (dropout masks, SPADE noise) in the rows' ORDER."""
    from hrviton_tpu_torch.models import discriminators, spade
    reordered = lambda draw, shape: _reorder(draw(tuple(shape)))
    discriminators.draw_rows = spade.draw_rows = reordered


def _state(prefix, module):
    return {f"{prefix}.{k}": v.detach().clone()
            for k, v in module.state_dict().items()}


def bn(mesh):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((GLOBAL_BATCH, 6, 5, 7)).astype(np.float32) * 2 + 1
    g = rng.standard_normal(x.shape).astype(np.float32)
    out = {}
    for affine in (True, False):
        m = BatchNorm2d(6, affine=affine, device="cpu")
        with torch.no_grad():
            m.running_mean.copy_(torch.from_numpy(rng.standard_normal(6)
                                                  .astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6)
                                                 .astype(np.float32)))
            if affine:
                m.weight.copy_(1 + 0.1 * torch.from_numpy(
                    rng.standard_normal(6).astype(np.float32)))
                m.bias.copy_(0.1 * torch.from_numpy(
                    rng.standard_normal(6).astype(np.float32)))
        xr = _rows(x, mesh).requires_grad_(True)
        with mesh_lib.sharded(mesh):
            y = m(xr, train=True)
            wrt = [xr] + list(m.parameters())
            grads = torch.autograd.grad((y * _rows(g, mesh)).sum(), wrt)
            # the parameters' gradients of the global sum: the ranks' sum
            pgrads = [t.clone() for t in grads[1:]]
            mesh_lib.average_grads(pgrads)
        commit_state(m)
        tag = "affine" if affine else "plain"
        out[f"{tag}.y"] = y.detach()
        out[f"{tag}.grad_x"] = grads[0]
        for name, t in zip(("weight", "bias"), pgrads):
            out[f"{tag}.grad_{name}"] = t * mesh.world_size
        out.update(_state(tag, m))
    return out


def _cond_batch(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda c: rng.standard_normal((n, HW, HW, c), dtype=np.float32)
    labels = rng.integers(0, 13, (n, HW, HW)).astype(np.int32)
    parse = (labels[..., None] == np.arange(13)).astype(np.float32)
    return {"cloth": {"paired": f(3)},
            "cloth_mask": {"paired": rng.uniform(0, 1, (n, HW, HW, 1)
                                                 ).astype(np.float32)},
            "parse_agnostic": f(13), "densepose": f(3),
            "parse_onehot": labels, "parse": parse,
            "pcm": parse[..., 3:4].copy(), "parse_cloth": f(3)}


def _gen_batch(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda c: np.tanh(rng.standard_normal((n, HW, HW, c),
                                              dtype=np.float32))
    labels = rng.integers(0, 13, (n, HW, HW)).astype(np.int32)
    parse = (labels[..., None] == np.arange(13)).astype(np.float32)
    return {"cloth": f(3),
            "cloth_mask": rng.uniform(0, 1, (n, HW, HW, 1)).astype(np.float32),
            "parse_agnostic": f(13), "densepose": f(3), "agnostic": f(3),
            "image": f(3), "parse": parse, "parse_cloth": f(3)}


def _vgg():
    vgg = Vgg19Features(device="cpu")
    init_weights(vgg, torch.Generator().manual_seed(7))
    return vgg.requires_grad_(False)


def _smooth_adam(state):
    """Adam's eps raised to 1e-3, so that its step is a continuous function
    of the gradient: with eps 1e-8 a first step is lr * sign(g), and a
    gradient that is zero in exact arithmetic (a conv bias before a norm)
    takes its sign from rounding noise, which any two summation orders draw
    differently. The ranks' reductions are what is tested, not Adam."""
    for net in (state.g, state.d):
        for group in net.opt.opt.param_groups:
            group["eps"] = 1e-3


def _record(out, step, state, metrics):
    """A step's metrics, the networks' averaged gradients (left in
    ``.grad`` by the trainers) and their parameters and buffers after it."""
    for k, v in metrics.items():
        out[f"metric{step}.{k}"] = v.detach().clone()
    for net, module in (("g", state.g.module), ("d", state.d.module)):
        for k, p in module.named_parameters():
            out[f"grad{step}.{net}.{k}"] = p.grad.detach().clone()
        out.update(_state(f"state{step}.{net}", module))


def cond(mesh):
    from hrviton_tpu_torch.train.condition_trainer import ConditionTrainer
    trainer = ConditionTrainer(
        TOCGConfig(ngf=8), CondDiscriminatorConfig(ndf=8, norm="batch",
                                                   ddropout=True),
        ConditionTrainConfig(), device="cpu", mesh=mesh)
    state = trainer.init(0)
    _smooth_adam(state)
    # kernels N(0, 1/fan_in), which keep the activations O(1) (the init's
    # N(0, 0.02) shrinks them layer by layer), and flows of a few pixels:
    # with the near-zero flows of a fresh init every bilinear sample sits on
    # a pixel centre, where the sampler's gradient jumps, and rounding alone
    # picks a side
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in list(state.g.module.modules()) + list(state.d.module.modules()):
            if isinstance(m, Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
        for i in range(5):
            getattr(state.g.module, f"flow_conv_{i}").bias.uniform_(
                -1.0, 1.0, generator=g)
    vgg = _vgg()
    out = {}
    for step in range(2):
        batch = _rows(_cond_batch(GLOBAL_BATCH, 10 + step), mesh)
        state, metrics = trainer.train_step(state, batch, vgg)
        _record(out, step, state, metrics)
    return out


def gen(mesh, norm_g):
    from hrviton_tpu_torch.train.generator_trainer import GeneratorTrainer
    trainer = GeneratorTrainer(
        SPADEGenConfig(ngf=8, num_upsampling_layers="more", norm_g=norm_g,
                       fine_height=HW, fine_width=HW),
        SPADEDiscriminatorConfig(ndf=8), GeneratorTrainConfig(gt_mode=True),
        PipelineConfig(fine_height=HW, fine_width=HW), device="cpu", mesh=mesh)
    state = trainer.init(0)
    _smooth_adam(state)
    frozen = {"vgg": _vgg(), "tocg": None}
    noise = torch.Generator().manual_seed(5)
    out = {}
    for step in range(2):
        batch = _rows(_gen_batch(GLOBAL_BATCH, 20 + step), mesh)
        state, metrics = trainer.train_step(state, batch, noise, noise, frozen)
        _record(out, step, state, metrics)
    return out


SCENARIOS = {"bn": bn, "cond": cond,
             "gen_instance": lambda m: gen(m, "spectralaliasinstance"),
             "gen_batch": lambda m: gen(m, "spectralaliasbatch")}


def main():
    global ORDER
    scenario, world, rank, port, out_dir = sys.argv[1:6]
    tag = world
    if world in ("1r", "1s"):
        ORDER, world = world[1], "1"
        _reorder_draws()
    world, rank = int(world), int(rank)
    torch.set_num_threads(2)
    if world > 1:
        mesh_lib.init_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
    try:
        mesh = mesh_lib.make_mesh("cpu")
        assert (mesh.world_size, mesh.rank) == (world, rank)
        result = SCENARIOS[scenario](mesh)
    finally:
        mesh_lib.shutdown_distributed()
    torch.save(result, os.path.join(out_dir, f"{scenario}_{tag}_{rank}.pt"))


if __name__ == "__main__":
    main()
