"""Share of the traced jobs' wall time in the job's serial host work
around the fold: the union of ``cli.prepare`` (config, settings, the
job's constructor), ``ingest.read``, ``ingest.split`` (chunk
boundaries), ``model.lines`` (the model text) and ``phase:emit`` (the
output write)."""

from harness.jobshare import job_share

SPANS = ("cli.prepare", "ingest.read", "ingest.split", "model.lines",
         "phase:emit")


def read(ctx):
    return job_share(ctx, SPANS)
