"""Share of the traced jobs' wall time that the fold's consumer (the
device side) sat waiting for its next chunk: the summed
``ingest.wait`` spans of the prefetch pipeline."""

from harness.jobshare import job_share


def read(ctx):
    return job_share(ctx, ("ingest.wait",), union=False)
