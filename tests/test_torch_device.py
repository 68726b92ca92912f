"""The port's ``data/device.to_device`` on the CPU, where it is the plain
copy: no pinned memory, no JAX. The batch is the port's own compact test
batch of two, name lists included, from a synthetic tree at 96x128. The
pinned, non-blocking path on the card is tested in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from hrviton_tpu_torch.config import DataConfig
from hrviton_tpu_torch.data.dataset import VitonHDDataset
from hrviton_tpu_torch.data.device import to_device
from hrviton_tpu_torch.data.loader import collate
from hrviton_tpu_torch.data.synthetic import make_synthetic_dataset
from hrviton_tpu_torch.utils import profiling

W, H = 96, 128


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = make_synthetic_dataset(str(tmp_path_factory.mktemp("viton")),
                                  n=2, w=W, h=H, modes=("test",))
    cfg = DataConfig(dataroot=root, datamode="test",
                     data_list="test_pairs.txt", fine_height=H, fine_width=W)
    ds = VitonHDDataset(cfg, mode="test_gen", compact=True)
    return collate([ds[i] for i in range(2)])


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_to_device_cpu_is_the_plain_copy(raw, device):
    """For every array the tensor of ``torch.from_numpy(v).to("cpu")``
    (values, dtype, shape), nested as the batch is; the name lists pass
    through as the same objects."""
    got = to_device(raw, device)
    assert set(got) == set(raw)
    assert got["im_name"] is raw["im_name"]
    assert all(got["c_name"][k] is v for k, v in raw["c_name"].items())
    arrays = 0
    for k, v in raw.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
        for kk, x in (v.items() if isinstance(v, dict) else [(None, v)]):
            if not isinstance(x, np.ndarray):
                continue
            t = got[k] if kk is None else got[k][kk]
            want = torch.from_numpy(x).to("cpu")
            assert t.device.type == "cpu" and t.dtype == want.dtype, (k, kk)
            assert t.shape == want.shape and torch.equal(t, want), (k, kk)
            arrays += 1
    assert arrays == len(list(_tensors(got))) == 10


def test_to_device_cpu_never_pins(raw, monkeypatch):
    """On the CPU nothing is pinned (pinned allocations and ``pin_memory``
    are refused, no tensor is pinned) and, with tracing on, the call
    records its one ``to_device`` span and moves no counter."""
    def refuse(*args, **kwargs):
        raise AssertionError("to_device pinned memory on the CPU")
    empty_like = torch.empty_like

    def unpinned_empty_like(*args, **kwargs):
        if kwargs.get("pin_memory"):
            refuse()
        return empty_like(*args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    monkeypatch.setattr(torch, "empty_like", unpinned_empty_like)
    was = profiling.enabled()
    profiling.clear()
    profiling.enable()
    try:
        got = to_device(raw, "cpu")
        assert [s.name for s in profiling.spans()] == ["to_device"]
        assert profiling.counters() == {"dropped": 0, "waits": 0}
    finally:
        profiling.clear()
        (profiling.enable if was else profiling.disable)()
    tensors = list(_tensors(got))
    assert len(tensors) == 10
    assert not any(t.is_pinned() for t in tensors)
