"""Share of the traced jobs' wall time in the garbage collector's
generation 1 and 2 passes: the union of the program's ``host.gc``
spans.  The tracer that records ``cli.prepare`` also records every such
pass, so a window with ``cli.prepare`` spans and no pass inside a job
reads 0; a program that records neither reads None."""

from harness.jobshare import job_share


def read(ctx):
    got = job_share(ctx, ("host.gc",))
    if got is None and ctx.named("cli.prepare") and \
            ctx.facts.get("job_spans_ns"):
        return 0.0
    return got
