"""On the card: each cell at its own size, a short window, the program's
reading within its limit and the control's past it. Skips without a
card; run on the card with
``python -m pytest portbench/tests/test_portbench_card.py -m cuda``."""

from __future__ import annotations

import json
import time

import pytest

from portbench.run import PKG, Spec, run_cell
from portbench.tests.conftest import with_open_cells


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.fixture
def spec(tmp_path):
    """The benchmark's own files, with the cells ``open_cells.json``
    keeps."""
    (tmp_path / "portbench").symlink_to(PKG)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(with_open_cells()))
    return Spec(tmp_path, PKG)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["smollm2-135m.land", "gpt2.restart",
                                      "smollm2-135m.swap",
                                      "smollm2-135m.serve1"])
def test_control_fails_where_the_program_passes(card, spec, workload):
    kw = dict(log=lambda *a: None)
    plain = run_cell(spec, workload, 2**31 + 4242, 12.0, False, card,
                     t_start=time.monotonic(), **kw)
    assert plain["correct"] is True, plain["compared"]
    ctl = run_cell(spec, workload, 2**31 + 4242, 12.0, False, card,
                   control=True, t_start=time.monotonic(), **kw)
    assert ctl["correct"] is False, ctl["compared"]
