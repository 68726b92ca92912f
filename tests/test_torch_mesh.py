"""The data-parallel layer (``hrviton_tpu_torch/core/mesh.py``) on the CPU.

* ``local_batch_size`` and ``shard_eval_batch`` on meshes of one and two
  ranks (no group needed for these): the eval batch's divisibility is that
  of the global batch (a local eval batch of 1 on two ranks runs), and the
  hint of a refusal speaks of the global batch;
* two gloo processes against one, each a child process
  (tests/torch_mesh_child.py, no JAX) started together with a time limit on
  a free port: BatchNorm2d in training mode (output, input and parameter
  gradients, staged running statistics, with and without affine): every
  value of every rank within 1e-5 of the one-process run's max|ref|; two
  ConditionTrainer steps (BatchNorm in the tocg and the discriminator,
  --Ddropout) and two GeneratorTrainer steps ('aliasinstance' and
  'aliasbatch'): every metric, every gradient of every step, every
  parameter and buffer (running statistics, spectral u/v) after every step,
  of every rank, within 1e-5 of the one-process run's max|ref| or, where
  the reference's own f32 rounding noise is larger, within four times that
  noise (the larger difference of two more reference runs, on the batches
  in reverse order and shifted by one row, the draws reordered with them:
  the same computation in exact arithmetic). The noise
  is real: the gradients of these small random networks, with BatchNorm
  after weak activations, move by up to a few percent of a tensor's max
  under a reordering of the batch alone. Adam's eps is raised to 1e-3 in
  these runs (tests/torch_mesh_child.py:_smooth_adam), so that its step is
  a continuous function of the gradient: with eps 1e-8 a first step is lr *
  sign(g), and the sign of a gradient that is zero in exact arithmetic
  comes from the rounding. The first step's losses, computed before any
  update, hold to 1e-5 with no allowance;
* the one-process helpers with no group: draws, gradients and metrics
  unchanged.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hrviton_tpu_torch.core import mesh as mesh_lib

CHILD = Path(__file__).with_name("torch_mesh_child.py")
ROOT = Path(__file__).resolve().parents[1]
ROW_KEYS = (".y", ".grad_x")          # a rank's rows of a global tensor


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env():
    return dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))


def run_children(cmds, timeout):
    """Start every command together; each must exit 0 within ``timeout``
    seconds (the others are killed when one fails or hangs)."""
    procs = [subprocess.Popen(c, env=child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _scenario(name, tmp_path, noise: bool, timeout=300):
    """(one-process result, [the one-process runs in other row orders],
    [rank 0, rank 1] results) of a scenario."""
    port = free_port()
    base = [sys.executable, str(CHILD), name]
    orders = ["1r", "1s"] if noise else []
    run_children([base + [w, "0", "0", str(tmp_path)] for w in ["1"] + orders] +
                 [base + ["2", str(r), str(port), str(tmp_path)]
                  for r in range(2)], timeout)
    load = lambda w, r: torch.load(tmp_path / f"{name}_{w}_{r}.pt")
    return load("1", 0), [load(w, 0) for w in orders], \
        [load("2", r) for r in range(2)]


def _err(got, want):
    return (got.double() - want.double()).abs().max().item()


def _close(key, got, want, noise=0.0, rel=1e-5):
    assert got.shape == want.shape, (key, got.shape, want.shape)
    scale = want.double().abs().max().item()
    err = _err(got, want)
    assert err <= max(rel * scale, 4 * noise, 1e-7), (key, err, scale, noise)


def _compare(one, ranks, others=()):
    assert set(ranks[0]) == set(one) == set(ranks[1])
    for key, want in one.items():
        noise = max([_err(o[key], want) for o in others], default=0.0)
        if key.endswith(ROW_KEYS):
            _close(key, torch.cat([r[key] for r in ranks]), want, noise)
        else:
            for r in ranks:
                _close(key, r[key], want, noise)


# ----------------------------------------------------------- no group needed

def _mesh(world, rank=0):
    return mesh_lib.Mesh(world, rank, torch.device("cpu"))


def test_local_batch_size():
    assert mesh_lib.local_batch_size(8) == 8            # no group: one process
    assert mesh_lib.local_batch_size(8, _mesh(2)) == 4
    assert mesh_lib.local_batch_size(6, _mesh(3)) == 2
    with pytest.raises(ValueError, match="global batch 5 not divisible by 2"):
        mesh_lib.local_batch_size(5, _mesh(2))


def test_shard_eval_batch_tests_the_global_batch():
    tree = {"image": np.zeros((1, 4, 4, 3), np.float32),
            "cloth": {"paired": np.ones((1, 4, 4, 3), np.float32)}}
    # a local eval batch of 1 on two ranks: global 2, which the data axis
    # (2) divides
    got = mesh_lib.shard_eval_batch(_mesh(2, 1), tree)
    assert isinstance(got["image"], torch.Tensor)
    assert got["cloth"]["paired"].shape == (1, 4, 4, 3)
    assert float(got["cloth"]["paired"].sum()) == 48.0
    # one process runs a batch whole
    one = mesh_lib.shard_eval_batch(_mesh(1), {"x": np.zeros((3, 2))})
    assert one["x"].shape == (3, 2)


def test_shard_eval_batch_refuses_in_global_terms(monkeypatch):
    # a data axis the global batch does not divide (more devices than the
    # ranks' rows cover): the hint names the global batch
    mesh = _mesh(2)
    monkeypatch.setattr(mesh_lib.Mesh, "shape", property(
        lambda self: {mesh_lib.DATA_AXIS: 4}))
    with pytest.raises(ValueError, match="global eval batch 2 not divisible "
                                         "by the data axis 4"):
        mesh_lib.shard_eval_batch(mesh, {"x": np.zeros((1, 2))})
    assert mesh_lib.shard_eval_batch(mesh, {"x": np.zeros((2, 2))})["x"].shape \
        == (2, 2)


def test_make_mesh_without_group():
    m = mesh_lib.make_mesh("cpu")
    assert (m.world_size, m.rank, m.group, m.is_main) == (1, 0, None, True)
    assert m.shape == {"data": 1}
    with pytest.raises(NotImplementedError, match="model axis"):
        mesh_lib.make_mesh("cpu", model_axis=2)
    assert mesh_lib.init_distributed("", 2, 0) is None
    with pytest.raises(ValueError, match="--num_processes and --process_id"):
        mesh_lib.init_distributed("127.0.0.1:1", None, 0, "cpu")
    with pytest.raises(ValueError, match="outside"):
        mesh_lib.init_distributed("127.0.0.1:1", 2, 2, "cpu")


def test_one_rank_changes_nothing():
    """One process without a group: sharded() is inert, draws keep their shape,
    gradients and metrics are untouched."""
    m = _mesh(1)
    g = torch.Generator().manual_seed(3)
    with mesh_lib.sharded(m):
        assert mesh_lib.active_mesh() is None
        a = mesh_lib.draw_rows(lambda s: torch.randn(s, generator=g), (2, 3))
    b = torch.randn((2, 3), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    grads = [torch.ones(3)]
    mesh_lib.average_grads(grads, m)
    assert torch.equal(grads[0], torch.ones(3))
    met = {"a": torch.tensor(2.0)}
    assert mesh_lib.mean_metrics(met, m) is met
    assert mesh_lib.all_mean(1.5, m) == 1.5


def test_draw_rows_takes_the_ranks_rows_of_the_global_draw():
    """Inside sharded() on rank r of N a draw of (b, ...) is rows
    [r*b, (r+1)*b) of the (N*b, ...) draw; the generator advances as the
    one-process draw advances it."""
    for rank in range(2):
        g = torch.Generator().manual_seed(4)
        with mesh_lib.sharded(_mesh(2, rank)):
            got = mesh_lib.draw_rows(lambda s: torch.randn(s, generator=g),
                                     (3, 5))
            after = torch.randn(2, generator=g)
        ref_g = torch.Generator().manual_seed(4)
        full = torch.randn((6, 5), generator=ref_g)
        assert torch.equal(got, full[3 * rank:3 * rank + 3])
        assert torch.equal(after, torch.randn(2, generator=ref_g))
    assert mesh_lib.active_mesh() is None


# ------------------------------------------------ two gloo ranks against one

@pytest.mark.parametrize("scenario", ["bn", "cond", "gen_instance",
                                      "gen_batch"])
def test_two_ranks_equal_one(scenario, tmp_path):
    trainer = scenario != "bn"
    one, others, ranks = _scenario(scenario, tmp_path, noise=trainer)
    if trainer:
        assert any(k.startswith("metric1.") for k in one)
        assert all(torch.isfinite(v).all() for v in one.values())
        # the first step's losses, computed before any update
        first = [k for k in one if k.startswith("metric0.")]
        _compare({k: one[k] for k in first}, [{k: r[k] for k in first}
                                              for r in ranks])
    if scenario == "gen_batch":
        # the alias norms' running statistics moved from (0, 1)
        means = [v for k, v in one.items()
                 if k.endswith("param_free_norm.running_mean")]
        assert means and all(m.abs().max() > 0 for m in means)
    _compare(one, ranks, others)
