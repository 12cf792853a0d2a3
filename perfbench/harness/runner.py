"""One run of one cell: set up, ramp, measure, (trace), drain, check.

The order is the contract's: the system is built and driven from the seed;
the loop's ramp (until ``ramp_completions`` requests have come back) is
set-up, so the window opens on steady load with every shape warmed; the
window lasts ``seconds``; a traced run then profiles ``trace_s`` more of
the same load; the loop stops sending and waits for what is open
(``drain_s``), so that each request across the window's end has the done
time its share of the window is prorated by; the window's peak memory is
read; the program's state is freed; and only then does the reference
judge a sample of what the window produced.

``correct`` is one predicate over one list of readings: every request
answered, and answered well, by the end of the drain, and every number
within its limit. With ``control`` the list is the control's readings in the
program's place, so a sound control run comes out not correct; the
program's own readings of that run are kept beside them.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import torch

from perfbench.harness import manifest, traffic as traffic_gen
from perfbench.harness.closed_loop import ClosedLoop, Record
from perfbench.harness.trace import TraceData, profile_window


@dataclass
class Run:
    """What a metric reader sees."""
    cell: dict
    cfg: dict
    traffic: dict
    records: list[Record]
    w0: float                 # window start, perf_counter seconds
    w1: float
    c0: dict                  # the system's counters at w0 and w1
    c1: dict
    trace: TraceData | None
    setup_s: float

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0


class GcPauses:
    """The cyclic collector's pauses in this process while it is open:
    (generation, start_ns, end_ns) on ``time.time_ns``'s clock."""

    def __init__(self):
        self.log: list = []
        self._t = 0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.time_ns()
        else:
            self.log.append((info["generation"], self._t, time.time_ns()))

    def close(self) -> None:
        gc.callbacks.remove(self._cb)

    def spans(self) -> list:
        return [(f"gc{g}", a, b) for g, a, b in list(self.log)]

    def totals(self) -> dict:
        return {"gc_s": [sum(b - a for g, a, b in self.log if g == n) / 1e9 for n in range(3)],
                "gc_n": [sum(1 for g, *_ in self.log if g == n) for n in range(3)]}


def passes(checks: list) -> bool:
    return all(c["value"] <= c["limit"] for c in checks)


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             *, device, t_process: float, control: bool = False) -> tuple[dict, Run, list]:
    """Returns (the result's fields but ``metrics``, the run, the checks
    judged)."""
    cuda = torch.device(device).type == "cuda"
    marks = [("start", time.perf_counter())]
    system = manifest.system(cfg["system"]).build(cfg, traffic, seed, device)
    marks.append(("build_s", time.perf_counter()))
    pool = traffic_gen.build_requests(traffic, seed, manifest.ROOT)
    loop = ClosedLoop(system.submit, system.outcome, pool, traffic["clients"],
                      traffic["stagger_s"])
    loop.start()
    if not loop.wait_completed(traffic["ramp_completions"], traffic["ramp_timeout_s"]):
        raise RuntimeError(f"ramp: {loop.completed} of {traffic['ramp_completions']} "
                           f"requests back in {traffic['ramp_timeout_s']} s")
    w0 = time.perf_counter()
    setup_s = time.time() - t_process
    marks.append(("ramp_s", w0))
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    c0 = system.counters()
    pauses = GcPauses()
    time.sleep(max(0.0, w0 + seconds - time.perf_counter()))
    w1 = time.perf_counter()
    c1 = system.counters()
    host = pauses.totals()
    td = None
    if trace:
        probes = system.probes()
        until = None
        name = traffic.get("trace_counter")
        if name:
            def count():
                return system.counters()[name]
            start = count()
            end = time.perf_counter() + traffic["trace_s"]
            while count() == start and time.perf_counter() < end:
                time.sleep(0.005)
            first = count()

            def until():
                return count() != first
        try:
            td = profile_window(traffic["trace_s"], probes,
                                lambda: system.spans() + pauses.spans(), until)
        finally:
            for p in probes.values():
                p.remove()
    pauses.close()
    marks.append(("window_and_trace_s", time.perf_counter()))
    stuck = loop.drain(traffic["drain_s"])
    marks.append(("drain_s", time.perf_counter()))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
           "setup_memory_peak_bytes": setup_peak}
    if td is not None:
        dev.update(busy_s=td.busy_s, window_s=td.window_s)
    system.close()
    records = loop.records
    marks.append(("close_s", time.perf_counter()))
    run = Run(cell, cfg, traffic, records, w0, w1, c0, c1, td, setup_s)
    readings = system.check(records, w0, w1, control)
    marks.append(("check_s", time.perf_counter()))
    judged = readings["control" if control else "program"]
    failed = [r for r in records if r.ok is not True]
    head = {"correct": not failed and passes(judged),
            "attempted": len(records), "failed": len(failed), "device": dev, "host": host}
    if control:
        head["program_check"] = readings["program"]
    if td is not None:
        head["breakdown"] = td.breakdown()
    if failed:
        head["errors"] = {"stuck": stuck, "first": [r.error for r in failed[:3]]}
    head["phases"] = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    return head, run, judged
