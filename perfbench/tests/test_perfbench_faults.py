"""A whole run of each cell at a CPU size, without the harness's look for
a card, with the timed path sound and then broken underneath: ``correct``
must come out true, then false for each fault the cell can have (a token
or an answer altered where it is produced; a step that returns its state
unchanged). Faults across chips or in a training batch have no place in
these one-card serving cells."""

from __future__ import annotations

import time

import pytest

from perfbench.harness import faults, runner
from perfbench.tests import tiny

SEED = 2**31 + 99


def _run(make):
    cell, cfg, traffic = make()
    head, _, checks = runner.run_cell(cell, cfg, traffic, SEED, 6.0, False, device="cpu",
                                      t_process=time.time())
    return head, checks


@pytest.mark.parametrize("make,fault,expect", [
    (tiny.chat, None, True),
    (tiny.chat, faults.alter_token, False),
    (tiny.chat, faults.stale_state, False),
    (tiny.search, None, True),
    (tiny.search, faults.alter_answer, False),
    (tiny.search, faults.stale_batch, False),
], ids=["chat", "chat-token-altered", "chat-state-unchanged", "search",
        "search-answer-altered", "search-stale-batch"])
def test_fault_turns_correct_false(monkeypatch, make, fault, expect):
    if fault is not None:
        fault(monkeypatch.setattr)
    head, checks = _run(make)
    assert head["correct"] is expect, (head, checks)
