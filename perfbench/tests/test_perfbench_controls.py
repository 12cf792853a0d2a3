"""The control: the reference one precision step below what each
configuration states, put in the program's place, must come out not
correct.

On the CPU, at the small sizes of ``tiny``: the control's readings lie
well above the program's. On a card (``-m cuda``), at each cell's own size
on three seeds: the program's numbers within their limits, and the run
with the control in the program's place not correct.

    python -m pytest -m cuda perfbench/tests/test_perfbench_controls.py
"""

from __future__ import annotations

import time

import pytest

from perfbench.harness import manifest, runner
from perfbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size there")
    return "cuda"


def _control_run(cell, cfg, traffic, seed, seconds, device):
    head, _, judged = runner.run_cell(cell, cfg, traffic, seed, seconds, False, device=device,
                                      t_process=time.time(), control=True)
    return head, {c["name"]: c for c in head["program_check"]}, {c["name"]: c for c in judged}


@pytest.mark.parametrize("make,names", [
    (tiny.chat, ["logit_gap"]),
    (tiny.search, ["emb_gap", "score_gap"]),
], ids=["chat", "search"])
def test_control_reads_above_the_program(make, names):
    _, prog, ctl = _control_run(*make(), 2**31 + 5, 4.0, "cpu")
    assert runner.passes(prog.values()), prog
    assert any(ctl[n]["value"] > 3 * prog[n]["value"] for n in names), (prog, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
@pytest.mark.parametrize("name", ["chat7b-rag", "search1m-ivf8"])
def test_control_fails_at_cell_size(card, name, seed):
    bench = manifest.load()
    cell = manifest.workload(bench, name)
    cfg, traffic = manifest.config(bench, cell["config"]), manifest.traffic(cell["traffic"])
    head, prog, ctl = _control_run(cell, cfg, traffic, seed, 20.0, card)
    assert runner.passes(prog.values()), prog
    assert head["correct"] is False, ctl
