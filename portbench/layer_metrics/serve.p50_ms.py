"""The median of the traced run's request latencies, from each
request's due time to its whole answer at the load generator (a failed
or unanswered request is infinitely late, written 1e12), in ms.  An
end-to-end quantity, read here without a bound: on a host shared with
other work its runs spread too widely for any bound the benchmark may
set (PERF.md)."""

from harness import common


def read(ctx):
    v = ctx.facts.get("p50_ms")
    return None if v is None else common.finite(v)
