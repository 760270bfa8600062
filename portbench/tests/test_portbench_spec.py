"""The harness finds a cell, a configuration and a per-layer metric that
are added as files and entries only, and every cell of the benchmark
runs end to end at a tiny size."""

from __future__ import annotations

import hashlib
import json

import pytest

from portbench.run import Spec
from portbench.tests.conftest import TINY_GPT2, run_tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def test_a_cell_a_config_and_a_metric_added_as_files(tiny_root):
    before = _digests(tiny_root)
    pkg = tiny_root / "portbench"
    (pkg / "configs" / "gpt2-narrow.json").write_text(
        json.dumps(dict(TINY_GPT2, n_embd=32)))
    (pkg / "traffic" / "restart-again.json").write_text(
        json.dumps({"kind": "restart", "write_cap_gib": 3}))
    (pkg / "limits" / "gpt2-narrow.restart-again.json").write_text(
        json.dumps({"bad_bytes": 0}))
    (pkg / "metrics" / "steps_made.again.py").write_text(
        "def read(rec):\n    return float(len(rec.steps)) or None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gpt2-narrow", "source": "x",
                             "file": "portbench/configs/gpt2-narrow.json",
                             "reduced": ["n_embd"], "why": "x"})
    bench["workloads"].append({"name": "gpt2-narrow.restart-again",
                               "config": "gpt2-narrow",
                               "traffic": "restart-again", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("time_to_hbm_s", "metadata_s.hbm"):
            m["workloads"].append("gpt2-narrow.restart-again")
    bench["per_layer"].append({
        "name": "steps_made.again", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "harness", "moves": "time_to_hbm_s",
        "workloads": ["gpt2-narrow.restart-again"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    spec = Spec(tiny_root, pkg)
    plain = run_tiny(spec, "gpt2-narrow.restart-again")
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"time_to_hbm_s", "setup_s"}
    traced = run_tiny(spec, "gpt2-narrow.restart-again", trace=True)
    assert traced["correct"] is True
    assert traced["metrics"]["steps_made.again"]["value"] >= 1
    assert "metadata_s.hbm" in traced["metrics"]


@pytest.mark.parametrize("workload", ["smollm2-135m.land", "gpt2.restart",
                                      "smollm2-135m.swap",
                                      "smollm2-135m.serve1"])
def test_every_cell_runs_and_reports_its_metrics(tiny_spec, workload):
    plain = run_tiny(tiny_spec, workload)
    assert plain["correct"] is True, plain["compared"]
    e2e = {m["name"] for m in tiny_spec.end_to_end(workload)}
    assert set(plain["metrics"]) == e2e and "setup_s" in e2e
    assert list(plain)[-1] == "judged" and list(plain)[-2] == "compared"
    traced = run_tiny(tiny_spec, workload, trace=True)
    assert traced["correct"] is True
    # Every per-layer metric of the cell reads something, except the
    # device's idle share, which has no device to read here.
    want = {m["name"] for m in tiny_spec.per_layer(workload)}
    got = set(traced["metrics"])
    assert got <= want and want - got <= {
        n for n in want if n.startswith("idle_share")} | got
    assert {"busy_s", "window_s"} <= set(traced["device"])
    for m in tiny_spec.per_layer(workload):
        assert m["moves"] in e2e
