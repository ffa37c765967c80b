"""The share of a batch cell's traced jobs that named program spans
cover: the per-layer readers of the job's host work use it."""

from __future__ import annotations

from typing import Iterable, Optional

from harness.stats import union_length


def job_share(ctx, names: Iterable[str], union: bool = True
              ) -> Optional[float]:
    """Time in the spans named ``names`` within the traced window's jobs
    (``facts["job_spans_ns"]``, as the benchmark timed them) over the
    jobs' summed wall time.  ``union`` counts time that several spans
    cover (parallel threads) once; otherwise the spans' clipped lengths
    add up.  None when the window holds no job or no such span (a
    program that does not record them)."""
    jobs = ctx.facts.get("job_spans_ns") or []
    names = set(names)
    iv = [(s.t0_ns, s.t0_ns + s.dur_ns) for s in ctx.spans
          if s.name in names]
    wall = sum(b - a for a, b in jobs)
    if not iv or wall <= 0:
        return None
    if union:
        inside = sum(union_length(iv, a, b) for a, b in jobs)
    else:
        inside = sum(max(0, min(e, b) - max(s, a))
                     for a, b in jobs for s, e in iv)
    return inside / wall
