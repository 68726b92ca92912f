"""The loader's host-time tool (``hrviton_tpu_torch/tools/bench_loader.py``)
at a tiny size on the CPU: both formats timed, the compact sample smaller
than the full one, the tree written under the temporary directory and
removed, or an existing tree read."""

import os

from hrviton_tpu_torch.data.synthetic import make_synthetic_dataset
from hrviton_tpu_torch.tools import bench_loader


def test_bench_loader_times_both_formats(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(bench_loader.tempfile, "tempdir", None)
    out = bench_loader.main(n=2, h=128, w=96)
    assert set(out) == {"full", "compact"}
    assert all(v["ms"] > 0 for v in out.values())
    assert out["compact"]["mb"] < out["full"]["mb"]
    assert os.listdir(tmp_path) == []
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["full", "compact"]


def test_bench_loader_reads_an_existing_tree(tmp_path):
    root = make_synthetic_dataset(str(tmp_path / "d"), n=2, w=96, h=128,
                                  modes=("train",))
    out = bench_loader.main(root=root, n=1, h=128, w=96)
    assert out["compact"]["mb"] < out["full"]["mb"]
