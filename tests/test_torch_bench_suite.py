"""``zest bench`` on the port, held to the JAX package's suite on the CPU.

- ``run_synthetic(device=False)`` runs the JAX package's benches, by
  name and in order, with its result keys;
- a host bench whose native library cannot be built is skipped, as in
  the JAX package; a device bench is not: without a card the suite
  raises, and ``zest bench`` exits non-zero unless ``--no-device``;
- ``bench_dcn_fetch`` moves every payload byte over loopback;
- ``zest bench --no-device [--json]`` prints what the suite measured.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zest_tpu import bench_suite as j_suite
from zest_tpu_torch import bench_suite, cli

ROOT = Path(__file__).resolve().parent.parent
DEVICE_BENCHES = ["blake3_64kb_device", "ici_all_gather", "ring_attention",
                  "pipeline_gpipe"]


@pytest.fixture
def no_card():
    """These cases hold the suite where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device benches run")


@pytest.fixture(scope="module")
def host_suite():
    return bench_suite.run_synthetic(device=False)


@pytest.fixture(scope="module")
def ref_names():
    return [r.name for r in j_suite.run_synthetic(device=False)]


def test_host_suite_names_equal_reference(host_suite, ref_names):
    want = ref_names
    assert [r.name for r in host_suite] == want
    assert "gearhash_cdc_4mb" in want and "dcn_fetch_pipelined" in want


def test_results_have_reference_keys(host_suite):
    ref = j_suite.BenchResult("x", 3, 1000.0, 4096, best_ns=900.0)
    mine = bench_suite.BenchResult("x", 3, 1000.0, 4096, best_ns=900.0)
    assert mine.as_dict() == ref.as_dict()
    no_best = bench_suite.BenchResult("x", 1, 0.0, 8)
    assert no_best.as_dict() == j_suite.BenchResult("x", 1, 0.0, 8).as_dict()
    for r in host_suite:
        d = r.as_dict()
        assert list(d) == ["name", "iters", "median_ns", "mb_per_s",
                           "best_mb_per_s"]
        assert d["median_ns"] > 0 and d["mb_per_s"] > 0


def test_format_results_equal_reference(host_suite):
    for as_json in (False, True):
        assert bench_suite.format_results(host_suite, as_json) == \
            j_suite.format_results(host_suite, as_json)


@pytest.mark.parametrize("bench,name", [
    ("bench_gearhash_cdc", "gearhash_cdc_4mb"),
    ("bench_wire_frame_native", "xet_frame_64kb")])
def test_native_bench_skipped_without_the_library(monkeypatch, ref_names,
                                                  bench, name):
    from zest_tpu_torch import native

    def broken():
        raise RuntimeError("g++ failed (1)")

    with monkeypatch.context() as m:
        m.setattr(native, "build", broken)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            getattr(bench_suite, bench)()

    def unbuilt(*_a, **_k):
        raise RuntimeError("native library build failed")

    monkeypatch.setattr(bench_suite, bench, unbuilt)
    names = [r.name for r in bench_suite.run_synthetic(device=False)]
    assert names == [n for n in ref_names if n != name]


def test_dcn_without_loopback_is_skipped(monkeypatch):
    def unavailable(**_kw):
        raise bench_suite.BenchUnavailable("loopback unavailable")

    monkeypatch.setattr(bench_suite, "bench_dcn_fetch", unavailable)
    names = [r.name for r in bench_suite.run_synthetic(device=False)]
    assert "dcn_fetch_pipelined" not in names


def test_dcn_failure_propagates(monkeypatch):
    def broken():
        raise TimeoutError("DCN request 3 timed out")

    monkeypatch.setattr(bench_suite, "bench_dcn_fetch", broken)
    with pytest.raises(TimeoutError):
        bench_suite.run_synthetic(device=False)


def test_bench_dcn_fetch_runs():
    r = bench_suite.bench_dcn_fetch(n_chunks=8, window=4, repeats=2)
    assert r.name == "dcn_fetch_pipelined"
    assert r.bytes_per_iter == 8 * 64 * 1024
    assert r.mb_per_s > 0
    ref = j_suite.bench_dcn_fetch(n_chunks=8, window=4, repeats=2)
    assert (r.iters, r.bytes_per_iter) == (ref.iters, ref.bytes_per_iter)


@pytest.mark.parametrize("bench", ["bench_blake3_device",
                                   "bench_ici_all_gather",
                                   "bench_ring_attention", "bench_pipeline"])
def test_device_bench_raises_without_a_card(no_card, bench):
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(bench_suite, bench)()


def test_suite_with_device_raises_without_a_card(no_card, monkeypatch):
    monkeypatch.setattr(bench_suite, "bench_dcn_fetch",
                        lambda: bench_suite.BenchResult("d", 1, 1.0, 1))
    with pytest.raises(RuntimeError, match="cuda"):
        bench_suite.run_synthetic(device=True)


def test_device_benches_on_the_cpu():
    """The device benches' own code at a CPU size: the names and bytes
    the JAX package's suite reports for them."""
    cpu = "cpu"
    b3 = bench_suite.bench_blake3_device(batch=2, iters=2, device=cpu)
    assert (b3.name, b3.iters, b3.bytes_per_iter) == \
        ("blake3_64kb_device", 2, 2 * 64 * 1024)
    ring = bench_suite.bench_ring_attention(t_per_device=32, heads=2,
                                            head_dim=16, device=cpu)
    assert (ring.name, ring.bytes_per_iter) == \
        ("ring_attention", 3 * 32 * 2 * 16 * 2)
    pipe = bench_suite.bench_pipeline(layers=2, width=32, rows=16,
                                      device=cpu)
    assert (pipe.name, pipe.bytes_per_iter) == ("pipeline_gpipe", 16 * 32 * 2)
    gather = bench_suite.bench_ici_all_gather(mbytes_per_device=1,
                                              device=cpu)
    assert gather.name == "ici_all_gather"
    assert [b3.name, gather.name, ring.name, pipe.name] == DEVICE_BENCHES
    assert all(r.median_ns >= 0 for r in (b3, ring, pipe, gather))


def test_cli_no_device_json(capsys, ref_names):
    assert cli.main(["bench", "--no-device", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert [r["name"] for r in doc] == ref_names
    assert cli.main(["bench", "--no-device", "--synthetic"]) == 0
    text = capsys.readouterr().out.splitlines()
    assert text[0].split() == ["bench", "iters", "median", "MB/s"]
    assert len(text) == len(doc) + 1


def test_cli_without_a_card_exits_nonzero(no_card):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "zest_tpu_torch", "bench", "--json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert proc.stdout == ""
