"""Share of the traced ``multi`` commands' wall time in the shared
scan's per-job host work a chunk: the union of the program's
``multiscan.encode`` spans (one a job a chunk, on the prefetch worker;
they hold the chunk's ``ingest.parse`` passes, which the first job to
ask for a view pays for)."""

from harness.jobshare import job_share


def read(ctx):
    return job_share(ctx, ("multiscan.encode",))
