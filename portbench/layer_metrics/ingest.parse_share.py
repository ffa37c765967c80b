"""Share of the traced jobs' wall time in the host's parse and encode:
the union of the program's ``ingest.parse`` spans (one a chunk around
the native encode and its vocabulary remap, on whichever thread runs
it), so parallel parse threads count once."""

from harness.jobshare import job_share


def read(ctx):
    return job_share(ctx, ("ingest.parse",))
