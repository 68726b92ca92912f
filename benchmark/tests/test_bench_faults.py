"""A run driven on the CPU past the look for a card, with the timed path
broken underneath: each fault an inference cell can have makes ``correct``
false, and the sound run is correct."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.tiny import tiny_root


def _run(tmp_path, batch=2, in_flight=1):
    root, bench = tiny_root(tmp_path, "float32", batch=batch, in_flight=in_flight)
    rec, out = bench_run.execute(bench, "tiny", 3 * 2 ** 31 + 17, 1.0, False,
                                 "cpu", root=root, log=lambda m: None)
    return out


def _patch(monkeypatch, alter):
    from hrviton_tpu_torch.pipelines import tryon
    forward = tryon._forward
    state = {}

    def broken(pipe, batch, fields):
        rgb, cond = forward(pipe, batch, fields)
        return alter(rgb, cond, state)
    monkeypatch.setattr(tryon, "_forward", broken)


def _one_image_altered(rgb, cond, state):
    rgb = rgb.clone()
    rgb[-1] = -rgb[-1]
    return rgb, cond


def _half_batch_left_out(rgb, cond, state):
    half = rgb.shape[0] // 2
    rgb = torch.cat([rgb[:half]] * 2)
    return rgb, cond._replace(
        warped_cloth=torch.cat([cond.warped_cloth[:half]] * 2),
        fake_parse_gauss=torch.cat([cond.fake_parse_gauss[:half]] * 2),
        parse_labels=torch.cat([cond.parse_labels[:half]] * 2))


def _stale_answer(rgb, cond, state):
    prev = state.get("prev")
    state["prev"] = (rgb, cond)
    return prev if prev is not None else (rgb, cond)


def _condition_altered(rgb, cond, state):
    return rgb, cond._replace(parse_labels=(cond.parse_labels + 1) % 7)


def _every_second_altered(rgb, cond, state):
    # with two requests in flight, the requests of one slot only
    state["n"] = state.get("n", 0) + 1
    return (-rgb if state["n"] % 2 else rgb), cond


@pytest.mark.parametrize("in_flight", [1, 2])
def test_sound_run_is_correct(tmp_path, in_flight):
    out = _run(tmp_path, in_flight=in_flight)
    assert out["correct"], out["check"]


@pytest.mark.parametrize("fault", [_one_image_altered, _half_batch_left_out,
                                   _stale_answer, _condition_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_caught(tmp_path, monkeypatch, fault):
    _patch(monkeypatch, fault)
    out = _run(tmp_path)
    assert not out["correct"], out["check"]


def test_fault_of_one_slot_is_caught(tmp_path, monkeypatch):
    _patch(monkeypatch, _every_second_altered)
    out = _run(tmp_path, in_flight=2)
    assert not out["correct"], out["check"]
