"""What a per-layer metric reader is given, from a traced run.

A reader is ``layer_metrics/<metric>.py`` with ``read(ctx)``, returning
a number or None when the run holds nothing for it to read (the metric
is then left out of the result line).  ``ctx`` is a LayerContext:

- ``spans``: the program's own spans (``core/obs.py`` records) that
  overlap the window;
- ``device``: the ``harness.devtrace.DeviceTrace`` of the window;
- ``lo_ns``, ``hi_ns``: the window on ``time.perf_counter_ns``;
- ``window_s``, ``busy_s``, ``breakdown``: the device trace's window
  (the span window, or a serving cell's traced burst after it), the
  time in it with an operation on the card, and the longest operations
  and idle stretches;
- ``facts``: what the cell's driver module counted (rows, jobs, job
  intervals, the program's counters before and after the window);
- ``config``: the cell's configuration file.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class LayerContext:
    def __init__(self, spans, device, lo_ns: int, hi_ns: int,
                 facts: Dict, config: Dict, device_window=None):
        def within(a, b):
            return [s for s in spans if s.t0_ns < b and s.t0_ns + s.dur_ns > a]
        self.spans = within(lo_ns, hi_ns)
        self.device = device
        self.lo_ns, self.hi_ns = lo_ns, hi_ns
        self.facts = facts
        self.config = config
        # the device's window: the span window unless the trace has one
        # of its own (a serving cell's burst)
        dlo, dhi = device_window or (lo_ns, hi_ns)
        if dlo is None or dhi is None:
            dlo, dhi = lo_ns, hi_ns
        self.window_s = (dhi - dlo) / 1e9
        self.busy_s = device.busy_ns(dlo, dhi) / 1e9
        self.breakdown = device.breakdown(dlo, dhi, within(dlo, dhi))

    def named(self, name: str) -> List:
        return [s for s in self.spans if s.name == name]

    def idle_share(self) -> Optional[float]:
        """1 - the device's busy time over the window; None when the
        trace holds no device operation at all."""
        if not self.device.events or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s
