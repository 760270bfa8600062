"""A run with the timed path broken underneath reads ``correct`` false:
a step that returns its state unchanged, half of the batch left out,
and an answer altered where it is produced. The chip check is skipped:
the run drives the rest of the harness on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests.conftest import run_tiny


@pytest.fixture
def broken_pull(monkeypatch):
    import zest_tpu_torch.transfer.pull as pull_mod

    real = pull_mod.pull_model

    def install(fault):
        def pull_model(*a, **kw):
            base = kw.get("base_params")
            kept = dict(base) if base is not None else None
            res = real(*a, **kw)
            if res.params is not None and res.stats.get("time_to_hbm_s") \
                    is not None:
                res.params = fault(res.params, kept)
            return res
        monkeypatch.setattr(pull_mod, "pull_model", pull_model)
    return install


def _unchanged(params, kept):
    return kept if kept is not None else params


def _half(params, _kept):
    names = sorted(params)
    return {n: params[n] for n in names[: len(names) // 2]}


def _altered(params, _kept):
    out = dict(params)
    name = sorted(out)[0]
    t = out[name].clone()
    t.view(-1).view(torch.uint8)[0] += 1
    out[name] = t
    return out


@pytest.mark.parametrize("workload", ["smollm2-135m.land", "gpt2.restart",
                                      "smollm2-135m.swap"])
@pytest.mark.parametrize("fault", [_half, _altered],
                         ids=["half_left_out", "answer_altered"])
def test_a_broken_landing_is_not_correct(tiny_spec, broken_pull, workload,
                                         fault):
    broken_pull(fault)
    res = run_tiny(tiny_spec, workload, seconds=1.0)
    assert res["correct"] is False
    assert res["compared"]["bad_bytes"]["value"] > 0


def test_a_swap_that_returns_its_state_unchanged_is_not_correct(
        tiny_spec, broken_pull):
    broken_pull(_unchanged)
    res = run_tiny(tiny_spec, "smollm2-135m.swap", seconds=1.0)
    assert res["correct"] is False


@pytest.fixture
def broken_serve(monkeypatch):
    from zest_tpu_torch.models.hbm_pool import HbmPool

    real = HbmPool.generate_for

    def install(fault):
        def generate_for(self, *a, **kw):
            out, info = real(self, *a, **kw)
            return fault(np.array(out), kw), info
        monkeypatch.setattr(HbmPool, "generate_for", generate_for)
    return install


def _token_altered(out, _kw):
    out[-3] = (out[-3] + 1) % 256
    return out


def _half_the_tokens(out, kw):
    return out[: len(out) - 64 // 2] if len(out) > 40 else out[:-4]


@pytest.mark.parametrize("fault", [_token_altered, _half_the_tokens],
                         ids=["token_altered", "half_left_out"])
def test_a_broken_serve_is_not_correct(tiny_spec, broken_serve, fault):
    broken_serve(fault)
    res = run_tiny(tiny_spec, "smollm2-135m.serve1", seconds=1.0)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", ["smollm2-135m.land", "gpt2.restart",
                                      "smollm2-135m.swap"])
def test_the_control_in_the_programs_place_is_not_correct(tiny_spec,
                                                          workload):
    res = run_tiny(tiny_spec, workload, seconds=1.0, control=True)
    assert res["correct"] is False
    assert res["compared"]["bad_bytes"]["value"] > 0
    assert res["judged"]["program_bad_bytes"] == 0


def test_a_run_past_its_write_cap_fails(tiny_root):
    import json

    from portbench.run import Spec

    path = tiny_root / "portbench" / "traffic" / "restart.json"
    traffic = json.loads(path.read_text())
    path.write_text(json.dumps(dict(traffic, write_cap_gib=1e-6)))
    spec = Spec(tiny_root, tiny_root / "portbench")
    with pytest.raises(RuntimeError, match="past its cap"):
        run_tiny(spec, "gpt2.restart", seconds=0.5)
