"""The device's side of a traced run: ``torch.profiler`` (CUDA activity
only) over a batch cell's first ``TRACE_SECONDS`` of jobs, or over a
burst of ``SERVE_TRACE_SECONDS`` of a serving cell's traffic after its
window, reduced to the intervals in which an operation ran on the card.
A longer trace costs minutes to read back: a second of serving holds
some hundred thousand device events.

Kineto stamps device events on the host's wall clock (ns since the
epoch); a pair of readings taken together at the start maps them onto
``time.perf_counter_ns``, the clock of the program's spans and of the
benchmark's window.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from harness.stats import gaps, union_length

#: seconds of a batch cell's window that a traced run records
TRACE_SECONDS = 10.0
#: seconds of the traced burst after a serving cell's window
SERVE_TRACE_SECONDS = 3.0


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.events: List[Tuple[str, int, int]] = []   # name, t0 ns, dur ns
        self._offset = 0
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None

    def start(self) -> None:
        """Start the trace; its window opens once the profiler is up
        (bringing it up takes seconds the first time)."""
        if self.device.type == "cuda":
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize(self.device)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self._offset = time.time_ns() - time.perf_counter_ns()
        self.start_ns = time.perf_counter_ns()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self) -> Optional[int]:
        """End the trace; returns when it ended (``perf_counter_ns``,
        once the device had finished what was queued), None if it was
        not running."""
        if self.prof is None:
            return None
        import torch
        torch.cuda.synchronize(self.device)
        self.end_ns = time.perf_counter_ns()
        self.prof.stop()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                out.append((e.name(), int(e.start_ns()) - self._offset,
                            int(e.duration_ns())))
        self.events = out
        self.prof = None
        return self.end_ns

    def kernels(self, substring: str) -> List[Tuple[str, int, int]]:
        return [e for e in self.events if substring in e[0]]

    def busy_ns(self, lo: int, hi: int) -> float:
        return union_length(((t, t + d) for _, t, d in self.events), lo, hi)

    def breakdown(self, lo: int, hi: int, spans=()) -> Dict[str, list]:
        """The ten device operations that took most time, and the ten
        longest stretches with nothing on the device, each named by the
        innermost program span that covers its middle."""
        by_name: Dict[str, int] = {}
        for name, t, d in self.events:
            if t + d > lo and t < hi:
                by_name[name[:120]] = by_name.get(name[:120], 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps(((t, t + d) for _, t, d in self.events), lo, hi),
                      key=lambda g: g[0] - g[1])[:10]
        named = []
        for a, b in idle:
            mid = (a + b) // 2
            host = _innermost(spans, mid) or "no program span"
            named.append([host, (b - a) / 1e9])
        return {"device_ops": [[n, d / 1e9] for n, d in ops],
                "idle_gaps": named}


def _innermost(spans, t: int) -> Optional[str]:
    best = None
    for s in spans:
        if s.t0_ns <= t < s.t0_ns + s.dur_ns:
            if best is None or s.dur_ns < best.dur_ns:
                best = s
    return best.name if best is not None else None
