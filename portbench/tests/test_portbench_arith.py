"""The pacing, the write-cap count and the FLOP and byte counters."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import checkpoints, flops, pacing, readers
from portbench.cells import Record

PKG = Path(__file__).resolve().parent.parent


def _cfg(name):
    return json.loads((PKG / "configs" / f"{name}.json").read_text())


def test_schedule_is_even_through_the_window():
    due = pacing.schedule(100.0, 30.0, 8)
    assert due[0] == 100.0 and len(due) == 8
    assert all(abs((b - a) - 3.75) < 1e-9 for a, b in zip(due, due[1:]))


def test_write_cap_leaves_eight_smollm_steps():
    cfg = _cfg("smollm2-135m")
    head = len(json.dumps(checkpoints.header(cfg), separators=(",", ":")))
    file_bytes = 2 * checkpoints.n_params(cfg) + 8 + head + 8
    assert 268_000_000 < file_bytes < 270_000_000
    cap = 3 * pacing.GIB
    # A set-up that writes the cache and two files leaves eight steps.
    setup = 3 * file_bytes
    assert pacing.max_steps(file_bytes, cap, setup) == 8
    assert setup + 8 * file_bytes <= cap < setup + 9 * file_bytes
    assert pacing.max_steps(file_bytes, cap, cap) == 0
    # GPT-2's file would leave only three landings.
    g = 4 * checkpoints.n_params(_cfg("gpt2"))
    assert pacing.max_steps(g, cap, 3 * g) == 3


def test_written_counts_new_and_rewritten_files(tmp_path):
    import os

    (tmp_path / "a").write_bytes(b"x" * 100)
    (tmp_path / "d").mkdir()
    s0 = pacing.file_states(tmp_path)
    assert pacing.written({}, s0) == 100
    assert pacing.written(s0, pacing.file_states(tmp_path)) == 0
    # A read that freshens the LRU time writes nothing.
    os.utime(tmp_path / "a")
    assert pacing.written(s0, pacing.file_states(tmp_path)) == 0
    # A new file, and one rewritten through a renamed temporary file.
    (tmp_path / "d" / "b").write_bytes(b"y" * 30)
    (tmp_path / "tmp").write_bytes(b"z" * 70)
    os.replace(tmp_path / "tmp", tmp_path / "a")
    s1 = pacing.file_states(tmp_path)
    assert pacing.written(s0, s1) == 100
    # A removed file, forgotten, written again at its path counts anew.
    (tmp_path / "a").unlink()
    s2 = pacing.present(s1)
    assert str(tmp_path / "a") not in s2
    (tmp_path / "a").write_bytes(b"w" * 70)
    assert pacing.written(s2, pacing.file_states(tmp_path)) == 70


def test_published_sizes():
    s, g = _cfg("smollm2-135m"), _cfg("gpt2")
    assert checkpoints.n_params(s) == 134_515_008
    assert len(checkpoints.layout(s)) == 272
    assert checkpoints.n_params(g) == 124_439_808
    assert len(checkpoints.layout(g)) == 148


def _brute_llama_flops(cfg, pos0, n, head_rows):
    E, F, V, L, H, KV, D = flops.llama_dims(cfg)
    total = 0
    for t in range(n):
        ctx = pos0 + t + 1
        per_layer = 2 * (E * H * D + 2 * E * KV * D + H * D * E + 3 * E * F)
        per_layer += 2 * H * D * ctx * 2   # q.k over ctx, then att.v
        total += L * per_layer
    return total + head_rows * 2 * V * E


@pytest.mark.parametrize("pos0,n,head", [(0, 1, 1), (0, 64, 1), (100, 1, 1),
                                         (5, 7, 7)])
def test_llama_flops_match_a_token_by_token_count(pos0, n, head):
    cfg = _cfg("smollm2-135m")
    assert flops.llama_forward_flops(cfg, pos0, n, head) == \
        _brute_llama_flops(cfg, pos0, n, head)


def test_h2d_share_and_idle_share():
    rec = Record(10.0)
    rec.steps = [{"hbm_s": 1.0, "stats": {"hbm": {"bytes": 64_000_000}}},
                 {"hbm_s": 0.5, "stats": {"hbm": {"bytes": 64_000_000}}}]
    assert readers.h2d_share(rec) == pytest.approx((0.1 + 0.2) / 2)
    rec.steps.append({"hbm_s": 1.0, "stats": {"hbm": {
        "bytes": 999, "swap": {"landed_bytes": 6_400_000}}}})
    assert readers.h2d_share(rec) == pytest.approx((0.1 + 0.2 + 0.01) / 3)
    assert readers.idle_share(rec) is None
    rec.trace = {"step_s": 2.0, "step_busy_s": 0.5, "busy_s": 1.0,
                 "window_s": 10.0}
    assert readers.idle_share(rec) == pytest.approx(75.0)
    rec.trace = {"step_s": 0.0, "step_busy_s": 0.0, "busy_s": 1.0,
                 "window_s": 10.0}
    assert readers.idle_share(rec) == pytest.approx(90.0)


def test_mfu_against_the_published_peak():
    rec = Record(10.0)
    assert readers.mfu(rec, "bfloat16") is None
    rec.window_flops = 989e12
    assert readers.mfu(rec, "bfloat16") == pytest.approx(10.0)


def test_trace_reduce_unions_and_names_gaps():
    from types import SimpleNamespace as NS

    import torch

    from portbench.trace import MARK, reduce

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, lo, hi, dev=cpu):
        return NS(name=name, time_range=NS(start=lo, end=hi),
                  device_type=dev)

    events = [ev(MARK + "window", 0, 1000), ev(MARK + "step_0", 0, 400),
              ev(MARK + "judge_0", 400, 1000),
              ev(MARK + "step_0", 0, 400, cuda),  # mirrored: not busy
              ev("k1", 100, 200, cuda), ev("k2", 150, 300, cuda),
              ev("copy", 600, 700, cuda), ev("k1", 1500, 1600, cuda)]
    out = reduce(events, host_s=0.002)  # the profiler's clock at half rate
    assert out["busy_s"] == pytest.approx(300 * 2e-6)
    assert out["window_s"] == pytest.approx(0.002)
    assert out["step_busy_s"] == pytest.approx(200 * 2e-6)
    assert out["step_s"] == pytest.approx(400 * 2e-6)
    assert out["device_ops"][0] == ["k2", pytest.approx(150 * 2e-6)]
    assert [g[0] for g in out["idle_gaps"]] == ["judge_0", "judge_0",
                                                "step_0"]
